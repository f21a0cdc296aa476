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


@pytest.mark.cuda
def test_auto_kernels_refuse_autograd_on_card(cuda):
    """On CUDA inputs that require grad, ops.* with impl="auto" raise (the
    kernels have no backward) as on the CPU; impl="torch" differentiates
    on the card to the CPU's gradient (f32, 1e-5)."""
    from repro_torch.kernels import ops
    g = torch.Generator().manual_seed(5)
    q, k, v = (torch.randn((1, 4, 64, 64), generator=g) for _ in range(3))
    x = torch.randn((1, 64, 2, 64), generator=g)
    bc = torch.randn((1, 64, 16), generator=g)
    dt = torch.rand((1, 64, 2), generator=g) * 0.1
    a, d = -torch.rand(2, generator=g), torch.ones(2)
    calls = {
        "attention": (lambda q, k, v, x, dt, impl: ops.attention(q, k, v, impl=impl)),
        "decode_attention": (lambda q, k, v, x, dt, impl: ops.decode_attention(
            q[:, :, 0], k, v, torch.full((1,), 50, device=q.device), impl=impl)),
        "ssd_scan": (lambda q, k, v, x, dt, impl: ops.ssd_scan(
            x, dt, a.to(x.device), bc.to(x.device), bc.to(x.device), d.to(x.device),
            chunk=32, impl=impl))}
    for name, fn in calls.items():
        grads = []
        for dev in ("cpu", cuda):
            ts = [t.to(dev).requires_grad_() for t in (q, k, v, x, dt)]
            if dev != "cpu":
                with pytest.raises(RuntimeError, match='impl="torch"'):
                    fn(*ts, "auto")
            out = fn(*ts, "torch")
            wrt = ts[3:] if name == "ssd_scan" else ts[:3]
            grads.append([t.cpu() for t in torch.autograd.grad(out.square().sum(), wrt)])
        for got, want in zip(grads[1], grads[0]):
            torch.testing.assert_close(got, want, atol=1e-5, rtol=1e-5)


@pytest.mark.cuda
@pytest.mark.parametrize("arch", ["llama3_8b", "zamba2_2_7b"])
def test_train_step_on_card_matches_cpu(cuda, arch):
    """One reduced f32 `build_train_step` step (the plain attention and
    SSD, no hand kernel) on the card against the CPU: loss and grad_norm
    to 1e-4, params to 1e-4 (AdamW's update is ±lr where a gradient is ~0,
    so a sign flip of one is allowed in 1e-4 of a leaf, within 2 lr)."""
    import dataclasses

    import numpy as np

    from repro_torch.configs import get_config, reduced_config
    from repro_torch.launch import steps, train
    from repro_torch.models import model as mdl
    from repro_torch.training import adamw_init
    cfg = dataclasses.replace(reduced_config(get_config(arch)), dtype="float32")
    params = mdl.init_params(cfg, seed=0, device="cpu")
    batch = train.make_batch(cfg, 2, 24, np.random.default_rng(2), "cpu")
    before = flash_attention.launches, flash_decode.launches, ssd_scan.launches
    out = []
    for dev in ("cpu", cuda):
        # the step updates params in place: each device starts from its own copy
        p = _to(params, dev) if dev != "cpu" else mdl.init_params(cfg, seed=0,
                                                                  device="cpu")
        p, _, info = steps.build_train_step(cfg)(
            p, adamw_init(p), {k: v.to(dev) for k, v in batch.items()})
        out.append((p, float(info["loss"]), float(info["grad_norm"])))
    (pc, lc, nc), (pg, lg, ng) = out
    assert abs(lg - lc) <= 1e-4 * abs(lc) and abs(ng - nc) <= 1e-4 * abs(nc)
    for a, b in zip(mdl.param_leaves(pg), mdl.param_leaves(pc)):
        a, b = a.cpu(), b
        off = ~torch.isclose(a, b, atol=1e-4, rtol=1e-4)
        assert int(off.sum()) <= max(1, b.numel() // 10_000)
        assert float((a - b).abs().max()) <= 2 * 3e-4
    assert (flash_attention.launches, flash_decode.launches,
            ssd_scan.launches) == before


@pytest.mark.cuda
def test_ring_decode_on_card_matches_cpu(cuda):
    """A reduced f32 llama3_8b with a window of 8: 12 tokens prefilled into
    a ring of 8, then 6 ring decode steps, on the card (B1, and B2 over the
    ring) against the CPU (plain versions): logits and the ring to 1e-4."""
    import dataclasses

    from repro_torch.configs import get_config, reduced_config
    from repro_torch.models import model as mdl
    cfg = dataclasses.replace(reduced_config(get_config("llama3_8b")),
                              dtype="float32", sliding_window=8)
    params = mdl.init_params(cfg, seed=0, device="cpu")
    prompt = torch.randint(0, cfg.vocab_size, (2, 12),
                           generator=torch.Generator().manual_seed(6))
    runs = []
    before = flash_attention.launches, flash_decode.launches
    for dev in ("cpu", cuda):
        p = _to(params, dev)
        lg, cache = mdl.prefill(cfg, p, {"tokens": prompt.to(dev)},
                                mdl.init_cache(cfg, 2, 8, device=dev))
        outs = [lg.cpu()]
        for i in range(6):
            lg, cache = mdl.decode_step(cfg, p, cache,
                                        (prompt[:, i].to(dev) + 1) % cfg.vocab_size,
                                        ring_buffer=True)
            outs.append(lg.cpu())
        runs.append(outs + [cache["k"].cpu(), cache["v"].cpu()])
    for got, want in zip(runs[1], runs[0]):
        torch.testing.assert_close(got, want, atol=1e-4, rtol=1e-4)
    assert flash_attention.launches == before[0] + cfg.num_layers
    assert flash_decode.launches == before[1] + 6 * cfg.num_layers


def _partitioned_serving(cuda, cfg, shape):
    """A prefill of 4 x 32 tokens (audio: 32 frames and a BOS token) into a
    cache of 40 and 3 serve steps of `cfg`, partitioned over four ranks
    sharing the card (B1 once per attention layer and rank, the audio
    decoder's twice, B3 once per Mamba2 layer and rank, the plain
    distributed decode) and over four CPU ranks: the logits and every
    cache tensor to 1e-4, the same collective bytes, B1, B2 and B3 counted
    on the card."""
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.launch import shardings as shd
    from repro_torch.launch import steps
    from repro_torch.launch.partition import shard_tree, unshard_tree
    from repro_torch.models import model as mdl
    from repro_torch.sp.common import GangMesh
    params = mdl.init_params(cfg, seed=0, device="cpu")
    g = torch.Generator().manual_seed(7)
    prompt = torch.randint(0, cfg.vocab_size, (4, 32), generator=g)
    audio = cfg.family == "audio"
    batch = {"tokens": prompt[:, :1] if audio else prompt}
    if audio:
        batch["frames"] = torch.randn((4, 32, cfg.d_model), generator=g)
    pre, dec = ShapeConfig("p", 32, 4, "prefill"), ShapeConfig("d", 40, 4, "decode")
    runs, counts = [], []
    before = flash_attention.launches, flash_decode.launches, ssd_scan.launches
    for dev in ("cpu", cuda):
        mesh = GangMesh([dev] * 4, shape, ("data", "model"))
        p = _to(params, dev)
        cache = mdl.init_cache(cfg, 4, 40, enc_len=32 if audio else 0, device=dev)
        lg, c = steps.build_prefill_step(cfg, pre)(
            shard_tree(p, shd.param_specs(cfg, p, mesh, fsdp=False), mesh),
            shard_tree(_to(batch, dev), shd.batch_specs(cfg, pre, mesh), mesh),
            shard_tree(cache, shd.cache_specs(cfg, cache, mesh, global_batch=4), mesh))
        sp = shard_tree(p, shd.param_specs(cfg, p, mesh, fsdp=False), mesh)
        outs = [unshard_tree(lg).cpu()]
        for i in range(3):
            tok = shard_tree(prompt[:, i].to(dev), shd.batch_specs(cfg, dec, mesh)["token"],
                             mesh)
            lg, c = steps.build_serve_step(cfg, dec)(sp, c, tok)
            outs.append(unshard_tree(lg).cpu())
        cache = []
        shd.walk(lambda path, x, n: cache.append(x.cpu()), unshard_tree(c))
        runs.append(outs + cache)
        counts.append(mesh.collective_bytes)
    for got, want in zip(runs[1], runs[0]):
        torch.testing.assert_close(got, want, atol=1e-4, rtol=1e-4)
    assert counts[1] == counts[0]
    mamba = cfg.num_layers if cfg.family in ("ssm", "hybrid") else 0
    attn = {"ssm": 0, "hybrid": cfg.num_layers // max(cfg.attn_every, 1),
            "audio": cfg.encoder_layers + 2 * cfg.num_layers}.get(cfg.family, cfg.num_layers)
    assert flash_attention.launches == before[0] + attn * 4
    assert flash_decode.launches == before[1]
    assert ssd_scan.launches == before[2] + mamba * 4


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(2, 2), (1, 4)], ids=lambda s: f"{s[0]}x{s[1]}")
def test_partitioned_steps_on_card_match_cpu(cuda, shape):
    """A reduced f32 dense model (8 q / 2 KV heads), 4 x 32 tokens into a
    cache of 40 and 3 serve steps, partitioned over four ranks sharing the
    card (B1 once per layer and rank, the plain distributed decode) against
    the same four ranks on the CPU: logits and caches to 1e-4, the same
    collective bytes."""
    import dataclasses

    from repro_torch.configs import get_config, reduced_config
    _partitioned_serving(cuda, dataclasses.replace(
        reduced_config(get_config("llama31_70b"), n_heads=8, n_kv=2), dtype="float32"), shape)


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(2, 2), (1, 4)], ids=lambda s: f"{s[0]}x{s[1]}")
def test_partitioned_moe_steps_on_card_match_cpu(cuda, shape):
    """The same for a reduced f32 olmoe-like model with 8 experts top-2 over
    the model ranks (capacity factor 1.25: prefill assignments dropped)."""
    import dataclasses

    from repro_torch.configs import get_config, reduced_config
    _partitioned_serving(cuda, dataclasses.replace(
        reduced_config(get_config("olmoe_1b_7b"), experts=8), dtype="float32"), shape)


def _partitioned_training(cuda, cfg, shape):
    """Two partitioned FSDP train steps of `cfg` on 4 x 32 tokens (audio:
    and 16 frames each) over four
    ranks sharing the card and over four CPU ranks: loss and grad norm to
    1e-5, the params to 1e-4 but for AdamW's ±lr sign flips, the same
    collective bytes, no kernel launched (the step differentiates the plain
    attention and SSD)."""
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.launch import shardings as shd
    from repro_torch.launch import steps
    from repro_torch.launch.partition import shard_tree, unshard_tree
    from repro_torch.models import model as mdl
    from repro_torch.sp.common import GangMesh
    from repro_torch.training import adamw_init
    params = mdl.init_params(cfg, seed=0, device="cpu")
    g = torch.Generator().manual_seed(7)
    batches = []
    for _ in range(2):
        tok = torch.randint(0, cfg.vocab_size, (4, 32), generator=g)
        batches.append({"tokens": tok,
                        "labels": torch.nn.functional.pad(tok[:, 1:], (0, 1), value=-1)})
        if cfg.family == "audio":
            batches[-1]["frames"] = torch.randn((4, 16, cfg.d_model), generator=g)
    shape_cfg = ShapeConfig("t", 32, 4, "train")
    runs = []
    before = flash_attention.launches, flash_decode.launches, ssd_scan.launches
    for dev in ("cpu", cuda):
        mesh = GangMesh([dev] * 4, shape, ("data", "model"))
        # a copy on each device: the step updates the params in place
        p = mdl.tree_like(params, [x.to(dev, copy=True) for x in mdl.param_leaves(params)])
        opt = adamw_init(p)
        pspecs = shd.param_specs(cfg, p, mesh, fsdp=True)
        sp = shard_tree(p, pspecs, mesh)
        so = shard_tree(opt, shd.opt_specs(pspecs, opt), mesh)
        infos, counts = [], []
        for b in batches:
            mesh.reset_bytes()
            sp, so, info = steps.build_train_step(cfg)(
                sp, so, shard_tree(_to(b, dev), shd.batch_specs(cfg, shape_cfg, mesh), mesh))
            infos.append((float(info["loss"]), float(info["grad_norm"])))
            counts.append(mesh.collective_bytes)
        runs.append((infos, unshard_tree(sp), counts))
    (want, want_p, want_c), (got, got_p, got_c) = runs
    for gi, wi in zip(got, want):
        for a, b in zip(gi, wi):
            assert abs(a - b) <= 1e-5 * abs(b), (got, want)
    for a, b in zip(mdl.param_leaves(got_p), mdl.param_leaves(want_p)):
        a, b = a.cpu(), b.cpu()
        off = ~torch.isclose(a, b, rtol=1e-4, atol=1e-4)
        assert int(off.sum()) <= max(1, b.numel() // 10_000)
        assert float((a - b).abs().max()) <= 2 * 3e-4 * 2
    assert got_c == want_c
    assert (flash_attention.launches, flash_decode.launches, ssd_scan.launches) == before


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(1, 4), (2, 2), (4, 1)], ids=lambda s: f"{s[0]}x{s[1]}")
def test_partitioned_train_step_on_card_matches_cpu(cuda, shape):
    """A reduced f32 dense model (8 q / 2 KV heads), two partitioned FSDP
    train steps on 4 x 32 tokens over four ranks sharing the card against
    the same four ranks on the CPU: loss and grad norm to 1e-5, the params
    to 1e-4 but for AdamW's ±lr sign flips, the same collective bytes, no
    kernel launched (the step differentiates the plain attention)."""
    import dataclasses

    from repro_torch.configs import get_config, reduced_config
    _partitioned_training(cuda, dataclasses.replace(
        reduced_config(get_config("llama31_70b"), n_heads=8, n_kv=2), dtype="float32"), shape)


@pytest.mark.cuda
def test_partitioned_train_step_memory_matches_the_dry_run(cuda):
    """mistral_7b at full width, 2 layers, 4 x 2048 tokens in bf16, its
    partitioned FSDP train step on four ranks sharing the card as (1, 4):
    the card's rise in memory over one step (after a first, every rank's
    temporaries and new outputs: the shards are views) within 10 % of four
    times the dry run's per-device account (`dryrun.run_combo` on that
    mesh: rank 0's temp and new outputs), as chip_smoke.py's
    `partition_train` line holds it on every mesh."""
    import dataclasses

    import numpy as np

    from repro_torch.configs import get_config
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.launch import dryrun, partition, steps, train
    from repro_torch.launch import shardings as shd
    from repro_torch.models import init_params
    from repro_torch.sp.common import GangMesh
    from repro_torch.training import adamw_init

    cfg = dataclasses.replace(get_config("mistral_7b"), num_layers=2)
    shape = ShapeConfig("train_4x2048", 2048, 4, "train")
    mesh = GangMesh([cuda] * 4, (1, 4), ("data", "model"))
    params = init_params(cfg, seed=0, device=cuda)
    opt = adamw_init(params)
    pspecs = shd.param_specs(cfg, params, mesh, fsdp=True)
    p = partition.shard_tree(params, pspecs, mesh)
    o = partition.shard_tree(opt, shd.opt_specs(pspecs, opt), mesh)
    b = partition.shard_tree(train.make_batch(cfg, 4, 2048, np.random.default_rng(0), cuda),
                             shd.batch_specs(cfg, shape, mesh), mesh)
    step = steps.build_train_step(cfg)
    p, o, _ = step(p, o, b)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    before = torch.cuda.memory_allocated()
    p, o, _ = step(p, o, b)
    torch.cuda.synchronize()
    rise = torch.cuda.max_memory_allocated() - before
    mem = dryrun.run_combo("mistral_7b", shape, layers=2, mesh=mesh)["memory"]
    account = 4 * (mem["temp_size_in_bytes"] + mem["output_size_in_bytes"]
                   - mem["alias_size_in_bytes"])
    assert abs(account / rise - 1) <= 0.10, (account, rise)


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(1, 4), (2, 2), (4, 1)], ids=lambda s: f"{s[0]}x{s[1]}")
def test_partitioned_moe_train_step_on_card_matches_cpu(cuda, shape):
    """The same for a reduced f32 olmoe-like model with 8 experts top-2
    (the loss with its load-balance term)."""
    import dataclasses

    from repro_torch.configs import get_config, reduced_config
    _partitioned_training(cuda, dataclasses.replace(
        reduced_config(get_config("olmoe_1b_7b"), experts=8), dtype="float32"), shape)


@pytest.mark.cuda
@pytest.mark.parametrize("arch,kw", [("mamba2_130m", {}), ("zamba2_2_7b", dict(layers=4))],
                         ids=["ssm", "hybrid"])
@pytest.mark.parametrize("shape", [(2, 2), (1, 4)], ids=lambda s: f"{s[0]}x{s[1]}")
def test_partitioned_ssm_steps_on_card_match_cpu(cuda, shape, arch, kw):
    """The same for reduced f32 ssm and hybrid models: 16 Mamba2 heads over
    the model ranks (B3 on each rank's heads, y and the final state
    gathered), the hybrid's shared block (4 MHA heads of 64) tensor-parallel
    with its cache's sequence over "model"."""
    import dataclasses

    from repro_torch.configs import get_config, reduced_config
    _partitioned_serving(cuda, dataclasses.replace(
        reduced_config(get_config(arch), **kw), dtype="float32"), shape)


@pytest.mark.cuda
@pytest.mark.parametrize("arch,kw", [("mamba2_130m", {}), ("zamba2_2_7b", dict(layers=4))],
                         ids=["ssm", "hybrid"])
@pytest.mark.parametrize("shape", [(1, 4), (2, 2), (4, 1)], ids=lambda s: f"{s[0]}x{s[1]}")
def test_partitioned_ssm_train_step_on_card_matches_cpu(cuda, shape, arch, kw):
    """Two partitioned train steps of the reduced f32 ssm and hybrid models
    (remat per Mamba2 layer; per hybrid segment) on the card against the
    CPU ranks, as `_partitioned_training` holds them."""
    import dataclasses

    from repro_torch.configs import get_config, reduced_config
    _partitioned_training(cuda, dataclasses.replace(
        reduced_config(get_config(arch), **kw), dtype="float32"), shape)


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(2, 2), (1, 4)], ids=lambda s: f"{s[0]}x{s[1]}")
def test_partitioned_audio_steps_on_card_match_cpu(cuda, shape):
    """The same for the reduced f32 seamless_m4t_large_v2 (2 encoder and 2
    decoder layers, 4 MHA heads over the model ranks): 32 frames and a BOS
    token, the self and the cross cache sequence-sharded."""
    import dataclasses

    from repro_torch.configs import get_config, reduced_config
    _partitioned_serving(cuda, dataclasses.replace(
        reduced_config(get_config("seamless_m4t_large_v2")), dtype="float32"), shape)


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(1, 4), (2, 2), (4, 1)], ids=lambda s: f"{s[0]}x{s[1]}")
def test_partitioned_audio_train_step_on_card_matches_cpu(cuda, shape):
    """Two partitioned train steps of the reduced f32 seamless_m4t_large_v2
    (remat per encoder and per decoder layer, the encoder's output an
    input of each decoder layer's) on the card against the CPU ranks."""
    import dataclasses

    from repro_torch.configs import get_config, reduced_config
    _partitioned_training(cuda, dataclasses.replace(
        reduced_config(get_config("seamless_m4t_large_v2")), dtype="float32"), shape)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("name", ["b1_causal_gqa", "b1_encoder", "b1_cross_row",
                                  "b1_window_offset", "b2_ragged", "b2_cross_full"])
def test_attention_kernels_match_the_reference_outputs(cuda, name, dtype):
    """B1 and B2 on the card against the reference's own Pallas outputs
    (interpret mode on a CPU, tests/data/attention_reference.npz, written
    by tests/test_torch_kernels.py run as a script; the inputs regenerated
    from the same numpy seed): f32 to 2e-5 elementwise, bf16 to B1_REL_TOL
    per (batch, head) (`kernels/checks.py`'s limits); one launch each."""
    from pathlib import Path

    import numpy as np

    from repro_torch.kernels.checks import (REFERENCE_CASES, reference_agrees,
                                            reference_call, reference_inputs)
    assert name in REFERENCE_CASES
    data = np.load(Path(__file__).resolve().parent / "data" / "attention_reference.npz")
    want = torch.from_numpy(data[f"{name}.{dtype}"]).to(cuda)
    q, k, v, lengths = (None if t is None else torch.from_numpy(t).to(cuda)
                        for t in reference_inputs(name, dtype))
    q, k, v = (t.to(getattr(torch, dtype)) for t in (q, k, v))
    before = flash_attention.launches + flash_decode.launches
    got = reference_call(name, q, k, v, lengths, flash_attention, flash_decode)
    assert flash_attention.launches + flash_decode.launches == before + 1
    assert got.shape == want.shape and got.dtype == q.dtype
    reference_agrees(got, want, dtype)


def _fixture_cases():
    """tests/data/ssd_scan_reference.npz (tests/test_torch_ssd.py writes it
    from the reference's Pallas kernel): {name: (dtype, chunk, inputs, y,
    state)}, numpy f32."""
    from pathlib import Path

    import numpy as np
    data = np.load(Path(__file__).resolve().parent / "data" / "ssd_scan_reference.npz")
    out = {}
    for name in sorted({k.split(".")[0] for k in data.files}):
        inp = {k.split(".")[1]: data[k] for k in data.files if k.startswith(name + ".")}
        out[name] = (str(inp.pop("dtype")), int(inp.pop("chunk")), inp, inp.pop("y"),
                     inp.pop("state"))
    return out


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["f32_96", "f32_200_init", "bf16_130_init"])
def test_ssd_kernel_matches_the_reference_outputs(cuda, name):
    """B3 on the card against the reference's own `ssd_scan_pallas` outputs
    (interpret mode on a CPU, stored with their inputs): f32 to 2e-5
    elementwise, bf16 to SSD_REL_TOL per (batch, head) on y and the state
    (`kernels/checks.py`'s limits); one launch each."""
    from repro_torch.kernels.checks import F32_TOL, SSD_REL_TOL, ssd_rel
    dtype, chunk, inp, wy, wh = _fixture_cases()[name]
    t = {k: torch.from_numpy(v).to(cuda) for k, v in inp.items()}
    if dtype == "bfloat16":
        t.update({k: t[k].bfloat16() for k in ("x", "B", "C")})
    before = ssd_scan.launches
    y, h = ssd_scan(t["x"], t["dt"], t["A"], t["B"], t["C"], t["D"], chunk=chunk,
                    init_state=t.get("init_state"), return_state=True)
    assert ssd_scan.launches == before + 1
    wy, wh = torch.from_numpy(wy).to(cuda), torch.from_numpy(wh).to(cuda)
    if dtype == "bfloat16":
        assert max(ssd_rel(y, h, wy, wh)) < SSD_REL_TOL
    else:
        torch.testing.assert_close(y, wy, atol=F32_TOL, rtol=F32_TOL)
        torch.testing.assert_close(h, wh, atol=F32_TOL, rtol=F32_TOL)
