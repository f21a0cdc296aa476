"""Mellum2 (`configs/mellum2_12b_a2_5b.py`) through the port's serving path,
held against the benchmark's plain reference (``bench/reference/mellum2.py``,
loaded by path: one reference for both), at a small f32 size of its shape:
two periods of three windowed layers and one full, 8 query heads over 1 KV
head of 16, a window of 8, YaRN over an original context of 16 at factor 4
(so the ramp spans the dims), 8 experts top-2.

On the CPU: the engine's prefill (whole, and one layer a quantum) and its
decode through the cache against the reference's full forward pass at every
position; the suffix prefill after a cached prefix; `expert_partial` against
the per-expert loop and the one-hot dispatch where a capacity drops
assignments; a decode with 2 of 4 lanes active against each lane alone, its
tally counting only their experts; `rope` against the YaRN formula and, at
the default, bit for bit as before; and each listed mutation (a window on
the full layers, YaRN dropped, the top-k renormalisation dropped, a pad row
given experts) reading outside the tolerance.  On the card (marker `cuda`):
B4 against its plain version at the main path's shapes, a replay against the
eager slice on the padded input bit for bit, and a decode step and a capture
with no synchronise."""
import dataclasses
import importlib.util
import math
from pathlib import Path

import pytest
import torch

from repro_torch.configs import get_config, reduced_config
from repro_torch.configs.layered import Rope, Yarn, layer_rope, layer_window
from repro_torch.core.spans import Tracer
from repro_torch.models import init_params
from repro_torch.models import layers as L
from repro_torch.models import model as mdl
from repro_torch.models import moe as MOE
from repro_torch.serving.engine import (ExpertTally, PrefillGraphs,
                                        ReplicaEngine, layer_slice)

# one intra-op thread: the suite runs several test workers on a few cores
torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parent.parent
#: f32 throughout, on the CPU: the engine's slices and the reference sum in
#: other orders (blocked attention, per-expert products, the cache), so
#: logits agree to a few f32 roundings of values ~1: 1e-4 leaves ~100x room
#: over what was read, and every mutation below moves them by >= 1e-2
TOL = 1e-4
WINDOW = 8


def _load_reference():
    path = ROOT / "bench" / "reference" / "mellum2.py"
    spec = importlib.util.spec_from_file_location("reference_mellum2", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


REF = _load_reference()


def small_cfg():
    base = get_config("mellum2_12b_a2_5b")
    return dataclasses.replace(
        base, num_layers=8, d_model=64, num_heads=8, num_kv_heads=1,
        head_dim=16, d_ff=32, vocab_size=256, num_experts=8,
        experts_per_token=2, capacity_factor=8.0, decode_capacity_factor=8.0,
        dtype="float32", layer_windows=(WINDOW, WINDOW, WINDOW, 0) * 2,
        full_rope=Rope(base.rope_theta, Yarn(4.0, 16, 32.0, 1.0,
                                             0.1 * math.log(4.0) + 1)))


@pytest.fixture(scope="module")
def model():
    cfg = small_cfg()
    return cfg, init_params(cfg, seed=3, device="cpu")


def reference(cfg, params, precision="f32"):
    y = cfg.full_rope.yarn
    c = {"num_heads": cfg.num_heads, "num_kv_heads": cfg.num_kv_heads,
         "head_dim": cfg.head_dim, "num_experts": cfg.num_experts,
         "experts_per_token": cfg.experts_per_token,
         "vocab_size": cfg.vocab_size, "norm_eps": cfg.norm_eps,
         "rope_theta": cfg.rope_theta, "full_rope_theta": cfg.full_rope.theta,
         "yarn": y._asdict(),
         "layers": [(cfg.num_heads, cfg.num_kv_heads, cfg.head_dim, w)
                    for w in cfg.layer_windows]}
    layers = [dict(pl["attn"], **pl["moe"], ln1=pl["ln1"], ln2=pl["ln2"])
              for pl in params["layers"]]
    w = {"embed": params["embed"], "final_norm": params["final_norm"],
         "lm_head": params["lm_head"], "layers": layers}
    return REF.Reference(c, w, precision)


def prompt(n, seed):
    return torch.randint(0, 256, (n,), generator=torch.Generator().manual_seed(seed))


def rel(a, b):
    return float((a - b).abs().max() / b.abs().max())


def serve(cfg, params, prompts, *, lpq, whole, new=3, max_slots=4):
    """Prefill each prompt on one engine (whole or `lpq` layers a quantum),
    admit them all, and decode `new` tokens for all lanes at once: each
    request's logits at its last prompt position and at each decoded one,
    and the tokens it was given."""
    eng = ReplicaEngine(cfg, params, max_slots=max_slots, max_len=64,
                        layers_per_quantum=lpq, block_size=4, device="cpu")
    logits, toks, slots = {}, {}, {}
    for rid, p in enumerate(prompts):
        st = eng.start_prefill(rid, p[None])
        st.whole = whole
        done = False
        while not done:
            st, done = eng.prefill_quantum(st)
        lg = eng.prefill_logits(st)
        logits[rid] = [lg[0]]
        toks[rid] = [int(lg[0].argmax())]
        slots[rid] = eng.admit(rid, st)
    step = mdl.decode_step

    def recording(*a, **kw):
        out = step(*a, **kw)
        recording.last = out[0]
        return out
    for _ in range(new):
        mdl.decode_step = recording
        try:
            nxt = eng.decode_iteration({slots[r]: toks[r][-1] for r in slots})
        finally:
            mdl.decode_step = step
        for r, s in slots.items():
            logits[r].append(recording.last[s])
            toks[r].append(nxt[s])
    return eng, logits, toks


def against_reference(cfg, params, prompts, logits, toks, ref=None):
    ref = ref or reference(cfg, params)
    worst = 0.0
    for rid, p in enumerate(prompts):
        seq = torch.cat([p, torch.tensor(toks[rid][:-1])])
        want = ref.logits([seq], [len(toks[rid])])[0]
        got = torch.stack(logits[rid])
        worst = max(worst, rel(got, want))
    return worst


PROMPTS = [(5, 1), (13, 2), (27, 3), (40, 4)]


@pytest.mark.parametrize("lpq,whole", [(1, False), (1, True), (3, False)])
def test_engine_prefill_and_decode_match_the_reference(model, lpq, whole):
    """Prompts of 5-40 tokens (past the window of 8), prefilled whole or a
    quantum at a time, then 3 tokens decoded with all four lanes at once:
    every position's logits within TOL of the reference's full forward
    pass, and the expert tallies follow the runs."""
    cfg, params = model
    prompts = [prompt(n, s) for n, s in PROMPTS]
    eng, logits, toks = serve(cfg, params, prompts, lpq=lpq, whole=whole)
    assert against_reference(cfg, params, prompts, logits, toks) <= TOL
    st = eng.tracer.stats
    assert st["moe_layer_runs.prefill"] == 4 * cfg.num_layers
    assert st["moe_layer_runs.decode_4"] == 3 * cfg.num_layers
    assert st["moe_rows"] == (sum(n for n, _ in PROMPTS) + 3 * 4) \
        * cfg.experts_per_token * cfg.num_layers
    # a prefill of 40 tokens reaches every expert of every layer; a decode
    # lane at most K of them
    assert st["moe_experts_touched.prefill"] > 0
    assert 3 * cfg.num_layers <= st["moe_experts_touched.decode_4"] \
        <= 3 * cfg.num_layers * 4 * cfg.experts_per_token


def test_suffix_prefill_after_a_cached_prefix(model):
    """A prompt sharing 16 cached tokens (4 blocks) with a parked one runs
    only its suffix, through the model's own layer function at positions
    16.., and gives the reference's logits."""
    cfg, params = model
    a = prompt(30, 7)
    b = torch.cat([a[:16], prompt(14, 8)])
    eng = ReplicaEngine(cfg, params, max_slots=2, max_len=64,
                        layers_per_quantum=2, block_size=4, device="cpu")
    st = eng.start_prefill(0, a[None])
    done = False
    while not done:
        st, done = eng.prefill_quantum(st)
    eng.cache_prompt(0, *st.full_kv(), host_tokens=tuple(a.tolist()))
    hit, pk, pv = eng.lookup_cached_prefix(tuple(b.tolist()))
    assert hit.n_tokens == 16
    st = eng.start_prefill(1, b[None], prefix_k=pk, prefix_v=pv)
    assert st.x.shape[1] == 14
    done = False
    while not done:
        st, done = eng.prefill_quantum(st)
    got = eng.prefill_logits(st)[0]
    want = reference(cfg, params).logits([b], [1])[0][0]
    assert rel(got, want) <= TOL
    k, _ = st.full_kv()
    assert k.shape[2] == 30


def per_expert_loop(cfg, p, r, x):
    """The dispatch as the port had it: the kept assignments grouped by
    expert on the host, one SwiGLU per expert with rows."""
    T, d = x.shape
    K = cfg.experts_per_token
    flat, keep = r.expert.flatten(), r.keep.flatten()
    y = torch.zeros((T * K, d))
    for e in range(cfg.num_experts):
        idx = torch.nonzero(keep & (flat == e)).squeeze(1)
        if idx.numel():
            xe = x[idx // K]
            h = torch.nn.functional.silu(xe @ p["w_gate"][e]) * (xe @ p["w_up"][e])
            y[idx] = (h @ p["w_down"][e]) * r.gate.flatten()[idx][:, None]
    return y.reshape(T, K, d).sum(1)


@pytest.mark.parametrize("cf", [1.25, 8.0])
def test_expert_partial_against_loop_and_onehot(cf):
    """olmoe's shape, 8 experts top-2, at its dropping capacity (1.25) and
    dropless: the device-side dispatch equals the per-expert loop and the
    reference's one-hot einsums; a range of experts and of tokens is the
    matching slice of the whole."""
    cfg = dataclasses.replace(reduced_config(get_config("olmoe_1b_7b"),
                                             experts=8, d_model=64, d_ff=32),
                              dtype="float32", capacity_factor=cf)
    p = init_params(cfg, seed=1, device="cpu")["layers"][0]["moe"]
    x = torch.randn((2, 48, cfg.d_model), generator=torch.Generator().manual_seed(5))
    r = MOE.route(cfg, p["router"], x, group_size=32)
    if cf < 2:
        assert not bool(r.keep.all())              # some are dropped
    xs = x.reshape(-1, cfg.d_model)
    got = MOE.expert_partial(cfg, p, r, xs)
    torch.testing.assert_close(got, per_expert_loop(cfg, p, r, xs),
                               atol=1e-6, rtol=1e-5)
    onehot, _ = MOE.moe_block_onehot(cfg, p, x, group_size=32)
    torch.testing.assert_close(got.reshape(x.shape), onehot, atol=1e-5, rtol=1e-5)
    half = {k: p[k][4:] for k in ("w_gate", "w_up", "w_down")}
    part = MOE.expert_partial(cfg, half, r, xs, e0=4, tokens=(10, 70))
    lo = {k: p[k][:4] for k in ("w_gate", "w_up", "w_down")}
    rest = MOE.expert_partial(cfg, lo, r, xs, e0=0, tokens=(10, 70))
    torch.testing.assert_close(part + rest, got[10:70], atol=1e-6, rtol=1e-5)


def four_lane_cache(cfg):
    cache = mdl.init_cache(cfg, 4, 32, device="cpu")
    gen = torch.Generator().manual_seed(11)
    cache["k"].normal_(generator=gen)
    cache["v"].normal_(generator=gen)
    cache["len"] = torch.tensor([5, 12, 20, 9], dtype=torch.int32)
    return cache


def lanes_of(cache, lanes):
    return {"len": cache["len"][lanes].clone(), "k": cache["k"][:, lanes].clone(),
            "v": cache["v"][:, lanes].clone()}


def tallied_decode(cfg, params, cache, tokens, active=None):
    t = torch.zeros((), dtype=torch.long)
    with MOE.tally_into(t):
        logits, _ = mdl.decode_step(cfg, params, cache, tokens, active=active)
    return logits, int(t)


def test_decode_two_of_four_lanes(model):
    """Lanes 1 and 3 active of 4: their logits are each lane's decoded
    alone, and the tally counts the experts of those two lanes alone (the
    same as a batch of just them); with every lane active it counts
    more."""
    cfg, params = model
    toks = torch.tensor([17, 40, 99, 3])
    active = torch.tensor([False, True, False, True])
    full = four_lane_cache(cfg)
    logits, n = tallied_decode(cfg, params, lanes_of(full, [0, 1, 2, 3]), toks, active)
    _, n_pair = tallied_decode(cfg, params, lanes_of(full, [1, 3]), toks[[1, 3]])
    for lane in (1, 3):
        alone, _ = tallied_decode(cfg, params, lanes_of(full, [lane]), toks[[lane]])
        torch.testing.assert_close(logits[lane], alone[0], atol=1e-5, rtol=1e-5)
    assert n == n_pair
    _, n_all = tallied_decode(cfg, params, lanes_of(full, [0, 1, 2, 3]), toks)
    assert n_all > n


def test_rope_yarn_and_default():
    """YaRN against a direct transcription of its formula (hd 128, theta
    5e5, factor 16 over 8192, betas 32 / 1: ramp from dim 18 to 35), and
    the default RoPE bit for bit as the port computed it before."""
    y = get_config("mellum2_12b_a2_5b").full_rope.yarn
    hd, theta = 128, 5e5
    x = torch.randn((2, 33, 4, hd), generator=torch.Generator().manual_seed(0))
    pos = torch.arange(4000, 4033)[None].expand(2, 33)
    i = torch.arange(64, dtype=torch.float64)
    pos_freq = theta ** (2 * i / hd)
    c = lambda r: hd * math.log(8192 / (2 * math.pi * r)) / (2 * math.log(theta))  # noqa: E731
    low, high = math.floor(c(32)), math.ceil(c(1))
    assert (low, high) == (18, 35)
    ramp = ((i - low) / (high - low)).clamp(0, 1)
    inv = (1 / pos_freq) * (1 - ramp) + (1 / (16 * pos_freq)) * ramp
    ang = pos[..., None].double() * inv
    cos = (torch.cos(ang) * y.attention_factor)[..., None, :]
    sin = (torch.sin(ang) * y.attention_factor)[..., None, :]
    x1, x2 = x[..., :64].double(), x[..., 64:].double()
    want = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], -1)
    got = L.rope(x, pos, theta, y)
    assert float((got.double() - want).abs().max()) < 2e-3
    # the default: the port's arithmetic before per-layer RoPE, bit for bit
    mistral = get_config("mistral_7b")
    half = hd // 2
    freqs = 1.0 / (mistral.rope_theta ** (torch.arange(half, dtype=torch.float32) / half))
    a = pos[..., None].float() * freqs
    cs, sn = torch.cos(a)[..., None, :], torch.sin(a)[..., None, :]
    old = torch.cat([x[..., :half] * cs - x[..., half:] * sn,
                     x[..., half:] * cs + x[..., :half] * sn], -1)
    assert torch.equal(L.rope(x, pos, mistral.rope_theta), old)
    assert layer_rope(mistral, 0) == Rope(mistral.rope_theta)
    assert layer_window(dataclasses.replace(mistral, sliding_window=40), 5) == 40


def test_layer_pattern():
    cfg = get_config("mellum2_12b_a2_5b")
    assert [layer_window(cfg, i) for i in range(8)] == [1024] * 3 + [0] + [1024] * 3 + [0]
    assert sum(1 for w in cfg.layer_windows if w) == 21
    assert layer_rope(cfg, 3).yarn is not None and layer_rope(cfg, 2).yarn is None
    assert cfg.sliding_window == 0 and cfg.capacity_factor == cfg.num_experts


def test_the_other_families_still_raise():
    for arch in ("mamba2_130m", "zamba2_2_7b", "seamless_m4t_large_v2",
                 "internvl2_76b"):
        cfg = dataclasses.replace(reduced_config(get_config(arch)), dtype="float32")
        with pytest.raises(NotImplementedError):
            ReplicaEngine(cfg, {}, device="cpu")


# ---- each mutation reads outside the tolerance --------------------------

def _served_error(cfg, params, monkeypatch=None):
    prompts = [prompt(n, s) for n, s in PROMPTS[2:]]
    eng, logits, toks = serve(cfg, params, prompts, lpq=1, whole=True, new=2)
    return against_reference(cfg, params, prompts, logits, toks,
                             ref=reference(small_cfg(), params))


def test_mutation_window_on_the_full_layers(model):
    cfg, params = model
    bad = dataclasses.replace(cfg, layer_windows=(WINDOW,) * cfg.num_layers)
    assert _served_error(bad, params) > 100 * TOL


def test_mutation_yarn_dropped(model):
    cfg, params = model
    bad = dataclasses.replace(cfg, full_rope=None)
    assert _served_error(bad, params) > 100 * TOL


def test_mutation_topk_renormalisation_dropped(model, monkeypatch):
    cfg, params = model
    route = MOE.route_logits

    def unnormalised(cfg_, logits, **kw):
        r = route(cfg_, logits, **kw)
        return r._replace(gate=r.probs.gather(-1, r.expert) * r.keep)
    monkeypatch.setattr(MOE, "route_logits", unnormalised)
    assert _served_error(cfg, params) > 100 * TOL


def _tally(fn):
    t = torch.zeros((), dtype=torch.long)
    with MOE.tally_into(t):
        fn()
    return int(t)


@pytest.mark.parametrize("S", [20, 64])
def test_pad_rows_take_no_expert(model, S, monkeypatch):
    """The whole-stack graph's work, run eagerly at its bucket (64) with
    its pad rows zeroed, tallies the experts the unpadded slice does, and
    its real rows equal the slice's; with the live mask dropped (the
    mutation) a short prompt's pad rows reach more experts."""
    cfg, params = model
    x = torch.randn((1, S, cfg.d_model), generator=torch.Generator().manual_seed(S))
    g = PrefillGraphs(cfg, params, device="cpu", max_len=64, tracer=Tracer())
    assert g.tally is not None
    def replayed():                     # the graph tallies into its own
        g.tally.reset()
        g._body(g._stage(x))
        return int(g.tally.t[0])
    padded = replayed()
    gx, gk, _ = g._real_rows(S)
    eager = []
    n = _tally(lambda: eager.append(layer_slice(cfg, params, x, 0, cfg.num_layers)))
    ex, kvs = eager[0]
    assert padded == n
    torch.testing.assert_close(gx, ex, atol=1e-5, rtol=1e-5)
    torch.testing.assert_close(gk[0], kvs[0].k[0], atol=1e-5, rtol=1e-5)
    if S < 64:
        orig = MOE.expert_partial

        def everyone(*a, live=None, **kw):
            return orig(*a, **kw)
        monkeypatch.setattr(MOE, "expert_partial", everyone)
        assert replayed() > n


def test_tally_reads_fold_into_the_counters():
    tr = Tracer()
    t = ExpertTally("cpu")
    t.slot(0).add_(5)
    t.slot(3).add_(2)
    assert t.read(torch.tensor([7, 8]), tr) == [7, 8]
    assert tr.stats["moe_experts_touched.prefill"] == 5
    assert tr.stats["moe_experts_touched.decode_3"] == 2
    t.slot(3).add_(1)
    t.read(torch.tensor(1), tr)
    assert tr.stats["moe_experts_touched.decode_3"] == 3
    t.reset()
    t.read(torch.tensor(1), tr)
    assert tr.stats["moe_experts_touched.decode_3"] == 3


# ---- on the card -------------------------------------------------------

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: B4 and CUDA graphs run only on the card")
    return torch.device("cuda")


def _rel_norm(a, b):
    return float((a.float() - b.float()).norm() / b.float().norm())


def _grouped(cuda, rows, E, K, N, dtype, seed):
    """Rows grouped over E experts by a random routing (some experts
    empty), and the live count below the rows."""
    from repro_torch.kernels import moe_grouped_gemm as mg
    g = torch.Generator().manual_seed(seed)
    live = rows - rows // 7
    counts = torch.bincount(torch.randint(0, E, (live,), generator=g), minlength=E)
    counts[E // 3] = 0
    counts[0] += live - int(counts.sum())
    offsets = torch.zeros(E + 1, dtype=torch.int32)
    offsets[1:] = counts.cumsum(0)
    a = torch.randn((rows, K), generator=g).to(cuda, dtype)
    b = (torch.randn((E, K, N), generator=g) * K ** -0.5).to(cuda, dtype)
    return mg, a, b, offsets.to(cuda), live


@pytest.mark.cuda
@pytest.mark.parametrize("rows,K,N", [(4096 * 8, 2304, 896), (4096 * 8, 896, 2304),
                                      (8, 2304, 896), (24, 896, 2304),
                                      (64, 2304, 896), (64, 896, 2304)])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_b4_against_plain(cuda, rows, K, N, dtype):
    """B4 at the main path's shapes (a 4096-token prefill's rows x 8, and
    1, 3 and 8 decode lanes x 8) over 64 experts, against one product per
    expert: bf16 within 5e-3 in relative norm (f32 sums in another order,
    rounded once), f32 within 1e-5; the live rows only; a second launch
    bit-equal; one launch counted per call."""
    mg, a, b, offsets, live = _grouped(cuda, rows, 64, K, N, dtype, rows + K)
    n = mg.moe_grouped_gemm.launches
    got = mg.moe_grouped_gemm(a, b, offsets)
    again = mg.moe_grouped_gemm(a, b, offsets)
    torch.cuda.synchronize()
    assert mg.moe_grouped_gemm.launches == n + 2
    want = mg.torch_grouped_gemm(a, b, offsets)
    assert _rel_norm(got[:live], want[:live]) <= (5e-3 if dtype == torch.bfloat16 else 1e-5)
    assert torch.equal(got[:live], again[:live])


def mellum_width(layers=4):
    """Mellum2 at its published widths, `layers` of them (one period)."""
    cfg = get_config("mellum2_12b_a2_5b")
    return dataclasses.replace(cfg, num_layers=layers,
                               layer_windows=cfg.layer_windows[:layers])


@pytest.mark.cuda
def test_replay_equals_eager_on_the_padded_input(cuda):
    """One period at full width in bf16: a replay at bucket 128 of a
    100-token prompt equals the eager slice run on the same padded input
    (pad rows zeroed, the live mask given) bit for bit, and tallies the
    same experts; B4's launches follow the replay."""
    from repro_torch.kernels.moe_grouped_gemm import moe_grouped_gemm
    cfg = mellum_width()
    params = init_params(cfg, seed=0, device=cuda)
    g = PrefillGraphs(cfg, params, device=cuda, max_len=256, tracer=Tracer())
    x = torch.randn((1, 100, cfg.d_model), device=cuda).to(torch.bfloat16)
    g.capture(128)
    n = moe_grouped_gemm.launches
    g.tally.reset()
    gx, gk, gv = g.run(x)
    assert moe_grouped_gemm.launches == n + 3 * cfg.num_layers
    tallied = int(g.tally.t[0])
    xp = torch.zeros((1, 128, cfg.d_model), device=cuda, dtype=torch.bfloat16)
    xp[:, :100] = x
    live = (torch.arange(128, device=cuda) < 100)[None]
    t = torch.zeros((), dtype=torch.long, device=cuda)
    with MOE.tally_into(t):
        ex, kvs = layer_slice(cfg, params, xp, 0, cfg.num_layers, live=live)
    assert torch.equal(gx, ex[:, :100])
    assert torch.equal(gk, torch.stack([kv.k[0, :, :100] for kv in kvs]))
    assert torch.equal(gv, torch.stack([kv.v[0, :, :100] for kv in kvs]))
    assert tallied == int(t) > 0


@pytest.mark.cuda
def test_decode_and_capture_do_not_synchronise(cuda):
    """A decode step of 8 lanes (3 active) and a whole-stack capture at full
    width, under ``set_sync_debug_mode("error")``: nothing reads back."""
    cfg = mellum_width()
    params = init_params(cfg, seed=0, device=cuda)
    cache = mdl.init_cache(cfg, 8, 256, device=cuda)
    cache["len"] = torch.tensor([5, 0, 100, 0, 0, 31, 0, 0], dtype=torch.int32,
                                device=cuda)
    tok = torch.tensor([1, 0, 2, 0, 0, 3, 0, 0], device=cuda)
    active = cache["len"] > 0
    g = PrefillGraphs(cfg, params, device=cuda, max_len=128, tracer=Tracer())
    t = torch.zeros((), dtype=torch.long, device=cuda)
    mdl.decode_step(cfg, params, cache, tok, active=active)    # warm
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        with MOE.tally_into(t):
            mdl.decode_step(cfg, params, cache, tok, active=active)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    g.capture(64)
    g.capture(128)
    torch.cuda.synchronize()
    assert 3 <= int(t) <= 3 * cfg.experts_per_token * cfg.num_layers
