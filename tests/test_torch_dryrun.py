"""The port's dry run (`repro_torch.launch.dryrun`, `dryrun_all`) and the
reference's ``ShapeDtypeStruct`` helpers' counterparts (`launch.steps`), at
full width: shapes only, on the meta device.

* `params_structs` / `opt_structs` / `batch_structs` / `cache_structs`
  against the reference's ``eval_shape`` trees (each per-layer leaf the
  reference's stacked leaf without its L axis, L of them);
* the record's argument bytes per device against the sum of the
  reference's ``NamedSharding(...).shard_shape`` blocks;
* `cost.flops` against the analytic 2·N·T (prefill), 6·N·T plus the
  layer remat (train: 2·N_layer·T but w_down, where the checkpoint's
  recompute stops; the head is not rematerialised) and 2·N·B (decode),
  each plus the plain attention's
  products (every tile of Sq x Sk: the plain version masks, it does not
  skip; train runs it five times: forward, layer remat, q-block remat,
  and the backward of both products), within 2 %, for mistral_7b and
  llama3_8b;
* the train account's extrapolation from 2 and 3 units equal to a run at
  full depth, and the replayed q-columns and SSD scans equal to ones run,
  for every family at reduced width;
* the matrix: the skip set is the reference's `supports_shape` (66 run,
  14 skipped), one shape per arch runs OK on both production meshes, every
  family's archs (`tp.FAMILIES`) with their collective bytes, train's too (the full matrix takes more than a minute on one
  core: it runs in `chip_smoke.py`'s dryrun phase and `python -m
  repro_torch.launch.dryrun_all`), and the CLIs write their records.
"""
import contextlib
import dataclasses
import json
import math
from unittest import mock

import jax
import numpy as np
import pytest
import torch
from jax.sharding import AbstractMesh, NamedSharding

from repro.configs import ARCH_IDS, INPUT_SHAPES, PAPER_ARCH_IDS
from repro.configs import get_config as j_get_config
from repro.launch import shardings as jshd
from repro.launch import steps as jst
from repro_torch.configs import get_config, reduced_config
from repro_torch.configs.base import ShapeConfig
from repro_torch.launch import dryrun, dryrun_all
from repro_torch.launch import shardings as shd
from repro_torch.launch import steps as st
from repro_torch.launch.mesh import make_host_mesh
from repro_torch.models import init_params, tp
from repro_torch.sp.common import GangMesh
from repro_torch.training import optimizer as opt
from torch.utils._python_dispatch import _disable_current_modes

torch.set_num_threads(1)

ALL_ARCHS = ARCH_IDS + PAPER_ARCH_IDS
FLOP_TOL = 0.02


def _dtype_name(t):
    return str(t.dtype).replace("torch.", "")


def _ref_leaf(tree, path):
    for c in path:
        if isinstance(c, int):
            continue
        tree = getattr(tree, c) if hasattr(tree, "_fields") else tree[c]
    return tree


def _held_structs(tree, jtree):
    """Every port leaf has the reference's shape (stacked: without its L
    axis, one leaf per layer) and dtype; every reference leaf is met."""
    seen = {}

    def check(path, x, n_stack):
        j = _ref_leaf(jtree, path)
        want = tuple(j.shape[1:]) if n_stack else tuple(j.shape)
        assert tuple(x.shape) == want, path
        assert n_stack in (0, j.shape[0]), path
        assert _dtype_name(x) == np.dtype(j.dtype).name, path
        assert x.device.type == "meta"
        key = tuple(c for c in path if not isinstance(c, int))
        seen[key] = seen.get(key, 0) + 1
    shd.walk(check, tree)
    assert len(seen) == len(jax.tree.leaves(jtree))


@pytest.mark.parametrize("arch", ALL_ARCHS)
def test_structs_match_reference(arch):
    cfg, jcfg = get_config(arch), j_get_config(arch)
    params, jparams = st.params_structs(cfg), jst.params_structs(jcfg)
    _held_structs(params, jparams)
    opt, jopt = st.opt_structs(params), jst.opt_structs(jparams)
    _held_structs(opt.moments, jopt.moments)
    assert tuple(opt.step.shape) == jopt.step.shape
    for shape in INPUT_SHAPES.values():
        for got, want in ((st.batch_structs(cfg, shape), jst.batch_structs(jcfg, shape)),
                          (st.cache_structs(cfg, shape), jst.cache_structs(jcfg, shape))):
            _held_structs(got, want)


def test_meta_init_draws_nothing_and_matches_the_cpu_tree():
    cfg = dataclasses.replace(reduced_config(get_config("zamba2_2_7b")), dtype="float32")
    meta, cpu = init_params(cfg, device="meta"), init_params(cfg, device="cpu")
    shd.walk(lambda path, m, n, c: (m.device.type == "meta" and m.shape == c.shape
                                    and m.dtype == c.dtype) or pytest.fail(str(path)),
             meta, cpu)
    again = init_params(cfg, device="cpu")      # the CPU draw is unchanged
    shd.walk(lambda path, a, n, b: torch.equal(a, b) or pytest.fail(str(path)), cpu, again)


def _ref_bytes(jtree, jspecs, jmesh):
    return sum(math.prod(NamedSharding(jmesh, s).shard_shape(x.shape)) * x.dtype.itemsize
               for x, s in zip(jax.tree.leaves(jtree),
                               jax.tree.leaves(jspecs, is_leaf=lambda s: isinstance(
                                   s, jax.sharding.PartitionSpec))))


@pytest.mark.parametrize("arch", ["internvl2_76b", "llama4_maverick_400b_a17b",
                                  "zamba2_2_7b", "seamless_m4t_large_v2", "llama3_8b"])
@pytest.mark.parametrize("multi_pod", [False, True])
def test_argument_bytes_match_reference_shards(arch, multi_pod, monkeypatch):
    """The record's per-device argument bytes = the reference's shard
    shapes summed (the step's own accounts stubbed out: argument bytes
    come from the spec trees alone)."""
    acct = dict(temp=0, new_out=0, flops=0, bytes=0, replaced=set(), units=1, units_run=[1])
    monkeypatch.setattr(dryrun, "step_account", lambda cfg, shape: acct)
    monkeypatch.setattr(dryrun, "rank_account", lambda cfg, shape, mesh, **kw: dict(
        acct, collectives={}))
    jmesh = (AbstractMesh((2, 16, 16), ("pod", "data", "model")) if multi_pod
             else AbstractMesh((16, 16), ("data", "model")))
    jcfg = j_get_config(arch)
    jparams = jst.params_structs(jcfg)
    for name, shape in INPUT_SHAPES.items():
        rec = dryrun.run_combo(arch, name, multi_pod=multi_pod)
        if rec.get("skipped"):
            continue
        fsdp = rec["fsdp"]        # the H100's decision (test_torch_sharding.py)
        jpspecs = jshd.param_specs(jcfg, jparams, jmesh, fsdp=fsdp)
        bspecs = jshd.batch_specs(jcfg, shape, jmesh)
        batch = jst.batch_structs(jcfg, shape)
        want = {"params": _ref_bytes(jparams, jpspecs, jmesh)}
        if shape.kind == "train":
            jopt = jst.opt_structs(jparams)
            want["opt"] = _ref_bytes(jopt, jshd.opt_specs(jpspecs, jopt), jmesh)
            want["batch"] = _ref_bytes(batch, bspecs, jmesh)
        else:
            jcache = jst.cache_structs(jcfg, shape)
            want["cache"] = _ref_bytes(jcache, jshd.cache_specs(
                jcfg, jcache, jmesh, global_batch=shape.global_batch), jmesh)
            if shape.kind == "prefill":
                want["batch"] = _ref_bytes(batch, bspecs, jmesh)
            else:
                want["token"] = _ref_bytes(batch["token"], bspecs["token"], jmesh)
        assert rec["memory"]["arguments"] == want, name
        assert rec["memory"]["argument_size_in_bytes"] == sum(want.values())


def _analytic_flops(cfg, shape):
    d, H, KV, hd, L = cfg.d_model, cfg.num_heads, cfg.num_kv_heads, cfg.head_dim, cfg.num_layers
    n_layer = d * hd * (H + 2 * KV) + H * hd * d + 3 * d * cfg.d_ff
    head = d * cfg.padded_vocab
    B, S = shape.global_batch, shape.seq_len
    if shape.kind == "decode":
        S_k = st.cache_lengths(cfg, shape)[0]
        return 2 * (L * n_layer + head) * B + L * 4 * B * H * S_k * hd
    T = B * S
    attn = L * 4 * B * H * S * S * hd
    if shape.kind == "prefill":
        return 2 * (L * n_layer + head) * T + attn
    # forward 2, layer remat 2 (all but w_down: the checkpoint's recompute
    # stops at the last tensor the backward saved), backward 4; the head is
    # not rematerialised
    return (8 * n_layer - 2 * d * cfg.d_ff) * L * T + 6 * head * T + 5 * attn


@pytest.mark.parametrize("arch,shape", [
    (a, s) for a in ("mistral_7b", "llama3_8b")
    for s in ("train_4k", "prefill_32k", "decode_32k", "long_500k")
    if st.supports_shape(get_config(a), INPUT_SHAPES[s])[0]])
def test_flops_match_the_analytic_count(arch, shape, monkeypatch):
    """The whole step's FLOPs (`cost_whole_step`; the per-device account,
    which this does not read, stubbed out)."""
    monkeypatch.setattr(dryrun, "rank_account", lambda cfg, shape, mesh, **kw: dict(
        temp=0, new_out=0, flops=0, bytes=0, replaced=set(), collectives={}, units=1,
        units_run=[1]))
    cfg = get_config(arch)
    rec = dryrun.run_combo(arch, shape)
    want = _analytic_flops(cfg, INPUT_SHAPES[shape])
    got = rec["cost_whole_step"]["flops"]
    assert abs(got / want - 1) <= FLOP_TOL, (got, want)
    assert rec["cost_whole_step"]["bytes accessed"] > 0


#: one reduced f32 config per family, cut to `units` units of depth
FAMILIES = ["mistral_7b", "olmoe_1b_7b", "mamba2_130m", "zamba2_2_7b",
            "seamless_m4t_large_v2", "internvl2_76b"]


def _reduced(arch, units):
    cfg = dataclasses.replace(reduced_config(get_config(arch)), dtype="float32")
    _, cut = dryrun._units(cfg)
    return cut(units)


def _factoring_switch(cfg, monkeypatch):
    """FACTOR_THRESHOLD patched between the stacked sizes at 3 and at 5
    units of cfg's largest 2-D per-layer leaf: whole at 3 units, factored
    at cfg's 5 (the 2- and 3-unit runs must carry the moments of 5)."""
    _, cut = dryrun._units(cfg)
    layers = st.params_structs(cfg)["layers"]
    per_unit = len(layers) // 5
    n, path = max((x.numel(), path) for path, x in _leaves(layers[0]) if x.dim() == 2)
    monkeypatch.setattr(opt, "FACTOR_THRESHOLD", n * 4 * per_unit)
    for units, factored in ((3, False), (5, True)):
        moments = st.opt_structs(st.params_structs(cut(units))).moments["layers"][0]
        for c in path:
            moments = moments[c]
        assert ("vr" in moments) == factored, (units, path)


def _leaves(tree, path=()):
    if isinstance(tree, dict):
        return [leaf for k, v in tree.items() for leaf in _leaves(v, path + (k,))]
    return [(path, tree)]


@pytest.mark.parametrize("arch,switch", [pytest.param(a, False, id=a) for a in FAMILIES]
                         + [pytest.param(a, True, id=f"{a}-factoring-switch")
                            for a in FAMILIES])
def test_train_account_extrapolates_exactly(arch, switch, monkeypatch):
    """The account at 5 units, run at 2 and 3 and extrapolated, equals a run
    at 5; with `switch` also where the optimizer factors a leaf at 5 units
    and not at 3 (`_factoring_switch`)."""
    cfg = _reduced(arch, 5)
    shape = ShapeConfig("t", 128, 2, "train")
    if switch:
        _factoring_switch(cfg, monkeypatch)
        dryrun.step_account.cache_clear()      # keyed by (cfg, shape) alone
    try:
        got = dryrun.step_account(cfg, shape)
    finally:
        if switch:
            dryrun.step_account.cache_clear()
    assert got["units"] == 5 and got["units_run"] == [2, 3]
    want = dryrun._run(cfg, shape)
    for k in ("temp", "new_out", "flops", "bytes"):
        assert got[k] == want[k], k


def _meta_mesh(shape):
    return GangMesh([torch.device("meta")] * math.prod(shape), shape, ("data", "model"))


@pytest.mark.parametrize("arch,switch", [pytest.param(a, False, id=a) for a in FAMILIES]
                         + [pytest.param(a, True, id=f"{a}-factoring-switch")
                            for a in FAMILIES])
def test_rank_train_account_extrapolates_exactly(arch, switch, monkeypatch):
    """One device's account of the partitioned train step on a (2, 2) meta
    mesh at 5 units, run at 2 and 3 and extrapolated, equals a run at 5:
    temp, new outputs, FLOPs, bytes and the collective bytes by kind; with
    `switch` also where the optimizer factors a leaf at 5 units and not at
    3 (`_factoring_switch`)."""
    cfg = _reduced(arch, 5)
    shape = ShapeConfig("t", 128, 2, "train")
    if switch:
        _factoring_switch(cfg, monkeypatch)
    mesh = _meta_mesh((2, 2))
    got = dryrun.rank_account(cfg, shape, mesh)
    assert got["units"] == 5 and got["units_run"] == [2, 3]
    want = dryrun._rank_run(cfg, shape, mesh, None, cfg)
    for k in ("temp", "new_out", "flops", "bytes", "replaced", "collectives"):
        assert got[k] == want[k], k
    assert got["collectives"]["total"] > 0 and got["temp"] > 0


def test_serve_temp_does_not_grow_with_the_cache_group():
    """The meta serve step's per-device peak (temp and new outputs) and
    FLOPs with the cache's sequence over 8 model ranks are no more than
    over 2 where each rank holds the same slice of the cache (2 x 256 and
    8 x 256 positions): rank 0 computes its own decode partial, not every
    member's of the group (`sp.decode.distributed_decode_local` on a
    uniform meta group)."""
    cfg = _reduced("mistral_7b", 2)
    got = {}
    for shape, ranks in (((1, 2), 2), ((1, 8), 8)):
        acct = dryrun.rank_account(cfg, ShapeConfig("d", 256 * ranks, 2, "decode"),
                                   _meta_mesh(shape))
        got[ranks] = (acct["temp"] + acct["new_out"], acct["flops"])
    assert got[8][0] <= got[2][0] and got[8][1] <= got[2][1], got


@pytest.mark.parametrize("name,kw", [("all_gather", dict(axis=0)), ("psum", {}),
                                     ("psum_scatter", dict(scatter_dimension=0)),
                                     ("all_to_all", dict(split_axis=0, concat_axis=1))])
def test_meta_collective_is_one_node_over_rank_0(name, kw):
    """On a meta group (uniform: every member holds rank 0's tensor) a
    collective under autograd is one node over rank 0's tensor alone, so
    its backward gives one gradient, not one per member to accumulate; its
    bytes count once forward and once backward."""
    from repro_torch.launch import partition
    from repro_torch.sp.common import collective
    mesh = _meta_mesh((1, 4))
    group = partition._meta_group(mesh, ("model",))
    x = torch.empty(8, 8, device="meta", requires_grad=True)
    y = collective(group, name, [x] * 4, ("model",), **kw)
    assert len(y) == 4 and all(t is y[0] for t in y)
    inputs = [f for f, _ in y[0].grad_fn.next_functions if f is not None]
    assert len(inputs) == 1
    y[0].sum().backward()
    assert x.grad.shape == x.shape
    forward = {"psum_scatter": 2 * 8 * 4, "all_gather": 32 * 8 * 4}.get(name, 8 * 8 * 4)
    assert mesh.collective_bytes[0]["total"] == forward + 8 * 8 * 4   # the dual: x's bytes


def _head_elsewhere(cfg, shape):
    """The lm head's FLOPs at every position but each sequence's last: the
    whole step's prefill (`model.prefill`, as the reference's) projects
    every position; the partitioned one the last alone."""
    return 2 * (shape.global_batch * shape.seq_len - shape.global_batch) * cfg.d_model \
        * cfg.padded_vocab


def test_dense_prefill_flops_per_device_sum_to_the_whole_step():
    """mistral_7b at full width, 2 layers, 2 x 8192 prefill on a (2, 4)
    meta mesh: its rules replicate no matmul (32 q and 8 KV heads, d_ff and
    the vocabulary divide over 4 model ranks, every matrix of a layer and
    the lm head is cut over "model", the batch over 2 data ranks), so the
    devices' FLOPs sum to the whole step's, but for the head, which the
    whole step runs at every position (`_head_elsewhere`)."""
    cfg = get_config("mistral_7b")
    shape = ShapeConfig("prefill_2x8192", 8192, 2, "prefill")
    mesh = _meta_mesh((2, 4))
    specs = shd.param_specs(cfg, st.params_structs(cfg), mesh, fsdp=False)
    cut = [spec for _, spec in _leaves(specs["layers"][0]) + [((), specs["lm_head"])]
           if len(spec) == 2]
    assert len(cut) == 8 and all("model" in tuple(spec) for spec in cut), cut
    pl = tp.plan(cfg, mesh, batch=2, seq=8192, long_context=False)
    assert pl.q_heads == pl.kv_heads == ("model",) and pl.batch == ("data",)
    rec = dryrun.run_combo("mistral_7b", shape, layers=2, mesh=mesh)
    cfg = dataclasses.replace(cfg, num_layers=2)
    got = rec["cost"]["flops"] * rec["n_devices"]
    want = rec["cost_whole_step"]["flops"] - _head_elsewhere(cfg, shape)
    assert abs(got / want - 1) <= FLOP_TOL, (got, want)


@pytest.mark.parametrize("mesh_shape", [(1, 4), (2, 2)])
def test_mamba2_prefill_flops_count_the_repeated_work(mesh_shape):
    """mamba2_130m at full width, 2 layers, 2 x 2048 prefill: every model
    rank runs in_proj, the conv, the gate and out_proj over the whole
    gathered sequence of its batch rows, and the scan's C·Bᵀ of every chunk
    with its heads (`tp._mamba`), so the devices' FLOPs exceed the whole
    step's by those of in_proj, out_proj and C·Bᵀ on the other m - 1 model
    ranks (the conv and the gate are elementwise: the count, matmuls, has
    none of them), less the head the whole step runs at every position."""
    cfg = get_config("mamba2_130m")
    shape = ShapeConfig("prefill_2x2048", 2048, 2, "prefill")
    mesh = _meta_mesh(mesh_shape)
    rec = dryrun.run_combo("mamba2_130m", shape, layers=2, mesh=mesh)
    cfg = dataclasses.replace(cfg, num_layers=2)
    T, d, di, ns, nh = 2 * 2048, cfg.d_model, cfg.d_inner, cfg.ssm_state, cfg.ssm_heads
    repeated = cfg.num_layers * 2 * T * (d * (2 * di + 2 * ns + nh) + di * d
                                         + cfg.ssm_chunk * ns)
    got = rec["cost"]["flops"] * rec["n_devices"] - rec["cost_whole_step"]["flops"]
    want = (mesh_shape[1] - 1) * repeated - _head_elsewhere(cfg, shape)
    assert abs(got / want - 1) <= FLOP_TOL, (got, want)


def _uncounted(obj, name):
    """Within: ``obj.<name>`` runs outside the account (its results never
    count): the planted fault of the card's check, rank 0's FSDP-gathered
    weights (`tp._weight`) left out."""
    fn = getattr(obj, name)

    def uncounted(*a, **kw):
        with _disable_current_modes():
            return fn(*a, **kw)
    return mock.patch.object(obj, name, uncounted)


def test_fsdp_train_temp_holds_the_gathered_layer():
    """The reduced mistral_7b's train step on a (4, 1) meta mesh (FSDP
    alone): rank 0's temp is at least one layer's whole weights (the
    gathered layer, whose shards alone are its arguments), and leaving
    the all-gathered weights out of the account lowers it by at least
    those alive at its peak, in a layer's backward after w_down's product:
    the layer's matrices (`tp._weight` gathers them; the norms' weights
    are whole) but w_down."""
    cfg = _reduced("mistral_7b", 2)
    shape = ShapeConfig("t", 128, 4, "train")
    mesh = _meta_mesh((4, 1))
    layer = st.params_structs(cfg)["layers"][0]
    nbytes = {path: x.numel() * x.element_size() for path, x in _leaves(layer)}
    gathered = sum(n for path, n in nbytes.items() if path[-1] not in ("ln1", "ln2"))
    acct = dryrun.rank_account(cfg, shape, mesh)
    with _uncounted(tp, "_weight"):
        fault = dryrun.rank_account(cfg, shape, mesh)
    assert acct["temp"] >= sum(nbytes.values())
    assert acct["temp"] - fault["temp"] >= gathered - nbytes[("mlp", "w_down")]
    assert fault["collectives"] == acct["collectives"]


@pytest.mark.parametrize("arch", FAMILIES)
def test_replayed_columns_equal_columns_run(arch, monkeypatch):
    cfg = _reduced(arch, 2)
    for shape in (ShapeConfig("p", 2304, 2, "prefill"), ShapeConfig("d", 2304, 2, "decode")):
        got = dryrun._run(cfg, shape)
        with monkeypatch.context() as m:
            m.setattr(dryrun._Account, "replaying",
                      lambda self: contextlib.nullcontext())
            want = dryrun._run(cfg, shape)
        assert got == want, shape.kind


def test_replay_serves_only_meta_calls_of_its_own_thread(monkeypatch):
    """Inside `_Account.replaying` a plain-attention call on CPU tensors of
    a shape already accounted on meta runs for real, as does a meta call
    from another thread: the replay reads the device, and its hook lives in
    the entering thread's context only."""
    from concurrent.futures import ThreadPoolExecutor

    from repro_torch.kernels import flash_attention as fa
    runs = []
    column = fa._q_column
    monkeypatch.setattr(fa, "_q_column", lambda *a, **kw: runs.append(
        a[0].device.type) or column(*a, **kw))
    g = torch.Generator().manual_seed(0)
    q, k, v = (torch.randn(1, 2, 8, 16, generator=g) for _ in range(3))
    want = fa.torch_attention(q, k, v, q_block=4, kv_block=4)
    meta = [t.to("meta") for t in (q, k, v)]
    runs.clear()
    with torch.no_grad(), dryrun._Account(meta) as acc, acc.replaying():
        fa.torch_attention(*meta, q_block=4, kv_block=4)   # one column run
        got = fa.torch_attention(q, k, v, q_block=4, kv_block=4)
        with ThreadPoolExecutor(1) as pool:
            pool.submit(fa.torch_attention, *meta, q_block=4, kv_block=4).result()
        fa.torch_attention(*meta, q_block=4, kv_block=4)   # replayed
    assert runs == ["meta", "cpu", "cpu", "meta", "meta"]
    torch.testing.assert_close(got, want, rtol=0, atol=0)


def test_alias_and_outputs_follow_the_donations():
    """Serve: the cache is returned in place but for "len" (replaced), the
    new outputs are the logits and that "len"; train: params and moments in
    place, the step count replaced."""
    host = make_host_mesh(1, devices=["cpu"])
    rec = dryrun.run_combo("llama3_8b", "decode_32k", mesh=host)
    mem = rec["memory"]
    B, V = 128, get_config("llama3_8b").padded_vocab
    assert mem["alias_size_in_bytes"] == mem["arguments"]["cache"] - 4 * B
    assert mem["output_size_in_bytes"] - mem["alias_size_in_bytes"] == B * V * 2 + 4 * B
    assert rec["n_devices"] == 1 and rec["mesh"] == "host1x1"
    rec = dryrun.run_combo("mamba2_130m", ShapeConfig("t", 256, 2, "train"), layers=2,
                           mesh=host)
    mem = rec["memory"]
    assert mem["alias_size_in_bytes"] == (mem["arguments"]["params"]
                                          + mem["arguments"]["opt"] - 4)
    assert mem["per_device_total"] == (mem["argument_size_in_bytes"] + mem["temp_size_in_bytes"]
                                       + mem["output_size_in_bytes"]
                                       - mem["alias_size_in_bytes"])


def test_matrix_skip_set_matches_reference():
    """66 combos run and 14 skip, the skipped ones the reference's, each
    record with the reference's reason and no account."""
    n_run = n_skip = 0
    for arch in ARCH_IDS:
        for name, shape in INPUT_SHAPES.items():
            ok, reason = jst.supports_shape(j_get_config(arch), shape)
            assert st.supports_shape(get_config(arch), shape) == (ok, reason)
            for mp in (False, True):
                if ok:
                    n_run += 1
                    continue
                rec = dryrun.run_combo(arch, name, multi_pod=mp)
                assert rec["skipped"] and rec["reason"] == reason and "memory" not in rec
                n_skip += 1
    assert (n_run, n_skip) == (66, 14)


#: a train combo cut to size for the test's time (the matrix runs train_4k)
TRAIN_SMALL = ShapeConfig("train_256", 256, 256, "train")


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_matrix_decode_combo_runs_on_both_meshes(arch):
    """The decode_32k record on both production meshes, and a train
    record: every family's (`tp.FAMILIES`) collective bytes by kind
    (counted by the partitioned steps: tests/test_torch_partition.py,
    tests/test_torch_partition_train.py, tests/test_torch_partition_moe.py,
    tests/test_torch_partition_ssm.py, tests/test_torch_partition_audio.py);
    the train record at 2 units of depth (`dryrun._units`: a hybrid unit
    `attn_every` layers, an audio unit an encoder and a decoder layer)."""
    kinds = {"all-gather", "all-reduce", "reduce-scatter", "all-to-all",
             "collective-permute", "total"}
    cfg = get_config(arch)
    assert cfg.family in tp.FAMILIES
    units, cut = dryrun._units(cfg)
    for mp, n in ((False, 256), (True, 512)):
        rec = dryrun.run_combo(arch, "decode_32k", multi_pod=mp)
        assert rec["ok"] and rec["n_devices"] == n
        assert rec["mesh"] == ("pod2x16x16" if mp else "pod16x16")
        mem = rec["memory"]
        assert mem["fits"] == (mem["per_device_total"] <= 80e9)
        assert mem["temp_size_in_bytes"] > 0 and mem["temp_whole_step_over_n"] > 0
        assert f"on {n} meta ranks" in mem["temp_scope"]
        assert ("one-hot" in mem["temp_scope"]) == (cfg.family == "moe")
        assert rec["cost"]["scope"] == "one device's program, unfused"
        assert rec["cost_whole_step"]["flops"] > rec["cost"]["flops"] > 0
        train = dryrun.run_combo(arch, TRAIN_SMALL, multi_pod=mp,
                                 layers=cut(2).num_layers)
        assert train["account"]["units"] == 2
        for r in (rec, train):
            assert set(r["collectives"]) == kinds and "collectives_reason" not in r
            assert r["collectives"]["total"] == sum(
                v for k, v in r["collectives"].items() if k != "total") > 0
        # FSDP: the weights gathered over the batch axes, their gradients
        # reduce-scattered back
        assert train["collectives"]["reduce-scatter"] > 0
        assert rec["cost"]["flops"] > 0


def test_cli_writes_records(tmp_path, capsys):
    out = tmp_path / "dry"
    assert dryrun_all.main(["--archs", "mamba2_130m", "--out", str(out)]) == 0
    recs = [json.loads(f.read_text()) for f in sorted(out.glob("*.json"))]
    assert len(recs) == 8 and all(r["ok"] for r in recs)
    assert "done: 8 ok, 0 skipped, 0 failed" in capsys.readouterr().out
    assert dryrun.main(["--arch", "qwen2_7b", "--shape", "long_500k",
                        "--out", str(out)]) == 0
    assert json.loads((out / "qwen2_7b.long_500k.pod16x16.json").read_text())["skipped"]
    assert "SKIP qwen2_7b.long_500k.pod16x16" in capsys.readouterr().out
