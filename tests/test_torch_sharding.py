"""The port's sharding layer (`repro_torch.models.sharding`,
`repro_torch.launch.{mesh,shardings}`) against the reference's, on the
production meshes (16, 16) and (2, 16, 16) and on host meshes (4, 1) and
(1, 4), at full width: shapes only, no data.

The reference's meshes are ``jax.sharding.AbstractMesh``es of the same
shapes; the port's are `GangMesh`es of meta devices (production) or of
``["cpu"] * 4`` (host).  Held here:

* `standard_rules` equal the reference's rule tables; `resolve_spec` /
  `resolve_first` give the specs the reference's `constrain` /
  `constrain_first` hand to ``with_sharding_constraint``;
* `batch_specs` for every arch x shape; `param_specs` / `opt_specs` /
  `cache_specs` for every arch of ARCH_IDS + PAPER_ARCH_IDS against the
  reference's on its ``ShapeDtypeStruct`` trees, each per-layer spec the
  reference's stacked spec with its leading None dropped;
* `shard_shapes` against ``NamedSharding(...).shard_shape``;
* `needs_fsdp` with the port's HBM set to the reference's 16e9 equal to
  the reference's, and the H100's decisions at 80e9 pinned.
"""
import itertools

import jax
import numpy as np
import pytest
import torch
from jax.sharding import AbstractMesh, NamedSharding

from repro.configs import ARCH_IDS, INPUT_SHAPES, PAPER_ARCH_IDS
from repro.configs import get_config as j_get_config
from repro.launch import shardings as jshd
from repro.launch import steps as jst
from repro.models import sharding as jsharding
from repro_torch.configs import get_config
from repro_torch.launch import shardings as shd
from repro_torch.launch import steps as st
from repro_torch.launch.mesh import make_host_mesh, make_production_mesh
from repro_torch.models import sharding

torch.set_num_threads(1)

ALL_ARCHS = ARCH_IDS + PAPER_ARCH_IDS
#: name -> (reference mesh, port mesh)
MESHES = {
    "pod16x16": (lambda: AbstractMesh((16, 16), ("data", "model")),
                 lambda: make_production_mesh()),
    "pod2x16x16": (lambda: AbstractMesh((2, 16, 16), ("pod", "data", "model")),
                   lambda: make_production_mesh(multi_pod=True)),
    "host4x1": (lambda: AbstractMesh((4, 1), ("data", "model")),
                lambda: make_host_mesh(1, devices=["cpu"] * 4)),
    "host1x4": (lambda: AbstractMesh((1, 4), ("data", "model")),
                lambda: make_host_mesh(4, devices=["cpu"] * 4)),
}


@pytest.fixture(scope="module", params=list(MESHES))
def meshes(request):
    ref, port = MESHES[request.param]
    return request.param, ref(), port()


def _same(got, want):
    assert tuple(got) == tuple(want), (got, want)


def test_mesh_shapes_and_devices():
    m = make_production_mesh()
    assert m.shape == {"data": 16, "model": 16} and m.n_ranks == 256
    assert {d.type for d in m.devices} == {"meta"}
    m = make_production_mesh(multi_pod=True)
    assert m.axis_names == ("pod", "data", "model") and m.n_ranks == 512
    assert make_host_mesh(4, devices=["cpu"] * 4).shape == {"data": 1, "model": 4}
    assert make_host_mesh(3, devices=["cpu"] * 4).shape == {"data": 1, "model": 3}
    assert make_host_mesh(8, devices=["cpu"] * 2).shape == {"data": 1, "model": 2}


def test_partition_spec_is_a_tuple_of_its_entries():
    spec = sharding.P("data", None, ("pod", "data"))
    assert tuple(spec) == ("data", None, ("pod", "data")) and len(spec) == 3
    assert spec == jax.sharding.PartitionSpec("data", None, ("pod", "data"))
    assert sharding.P() == ()
    assert tuple(sharding.P(("model",), (), ("a", "b"))) == ("model", None, ("a", "b"))


@pytest.mark.parametrize("long_context,fsdp,seq_over_model",
                         list(itertools.product((False, True), repeat=3)))
def test_standard_rules_match_reference(meshes, long_context, fsdp, seq_over_model):
    _, jmesh, mesh = meshes
    kw = dict(long_context=long_context, fsdp=fsdp, seq_over_model=seq_over_model)
    assert sharding.standard_rules(mesh, **kw).rules == \
        jsharding.standard_rules(jmesh, **kw).rules


#: (shape, logical axes) constrain cases; options for constrain_first
CONSTRAIN = [
    ((32, 32768, 4096), ("batch", "seq", "embed")),
    ((1, 524288, 4096), ("batch", "seq", "embed")),
    ((32, 28, 4096, 128), ("batch", "heads", "seq", None)),
    ((32, 4096, 8, 128), ("batch", "seq", "kv_heads", None)),
    ((256, 4096, 14336), ("batch", "seq", "ff")),
    ((128, 8, 32768, 128), ("batch", "kv_heads", "cache_seq", None)),
    ((2, 3, 5), ("batch", "seq", "vocab")),
    ((4096, 128256), ("fsdp", "vocab")),
]
FIRST = [
    ((32, 28, 4096, 128), (("batch", "heads", None, None), ("batch", None, "seq", None))),
    ((32, 32, 4096, 128), (("batch", "heads", None, None), ("batch", None, "seq", None))),
    ((3, 5, 7), (("batch", "heads", None), ("batch", None, "seq"))),
    ((32, 64, 8), (("fsdp", "embed", None), (None, "state", None))),
]


def _captured(fn, *args):
    """The spec the reference's fn hands to with_sharding_constraint (None:
    not called)."""
    seen = []

    def capture(x, s):
        seen.append(s.spec)
        return x
    orig = jax.lax.with_sharding_constraint
    jax.lax.with_sharding_constraint = capture
    try:
        fn(*args)
    finally:
        jax.lax.with_sharding_constraint = orig
    return seen[0] if seen else None


@pytest.mark.parametrize("long_context,fsdp", [(False, False), (True, True)])
def test_resolve_spec_matches_reference_constrain(meshes, long_context, fsdp):
    _, jmesh, mesh = meshes
    for shape, axes in CONSTRAIN:
        x = jax.ShapeDtypeStruct(shape, np.float32)
        with jsharding.use_rules(jsharding.standard_rules(
                jmesh, long_context=long_context, fsdp=fsdp)):
            want = _captured(jsharding.constrain, x, *axes)
        with sharding.use_rules(sharding.standard_rules(
                mesh, long_context=long_context, fsdp=fsdp)):
            _same(sharding.resolve_spec(shape, *axes), want)
            t = torch.empty(shape, device="meta")
            assert sharding.constrain(t, *axes) is t
    assert sharding.resolve_spec((4, 4), "batch", None) is None    # no rules


@pytest.mark.parametrize("long_context", [False, True])
def test_resolve_first_matches_reference_constrain_first(meshes, long_context):
    _, jmesh, mesh = meshes
    for shape, options in FIRST:
        x = jax.ShapeDtypeStruct(shape, np.float32)
        with jsharding.use_rules(jsharding.standard_rules(jmesh, long_context=long_context)):
            want = _captured(jsharding.constrain_first, x, *options)
        with sharding.use_rules(sharding.standard_rules(mesh, long_context=long_context)):
            got = sharding.resolve_first(shape, *options)
            t = torch.empty(shape, device="meta")
            assert sharding.constrain_first(t, *options) is t
        if want is None:
            assert got is None
        else:
            _same(got, want)


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_batch_specs_match_reference(meshes, arch):
    _, jmesh, mesh = meshes
    cfg, jcfg = get_config(arch), j_get_config(arch)
    for shape in INPUT_SHAPES.values():
        got = shd.batch_specs(cfg, shape, mesh)
        want = jshd.batch_specs(jcfg, shape, jmesh)
        assert got.keys() == want.keys()
        for k in got:
            _same(got[k], want[k])


def _ref_leaf(tree, path):
    """The reference's leaf at the port's path (list indices dropped)."""
    for c in path:
        if isinstance(c, int):
            continue
        tree = getattr(tree, c) if hasattr(tree, "_fields") else tree[c]
    return tree


def _held(port_specs, ref_specs, port_tree):
    """Every port leaf's spec is the reference's, its stacked None dropped."""
    n = []

    def check(path, spec, n_stack):
        want = tuple(_ref_leaf(ref_specs, path))
        _same(spec, want[1:] if n_stack else want)
        n.append(1)
    shd.walk(check, port_specs)
    assert n, "no leaf compared"


@pytest.fixture(scope="module")
def structs():
    """arch -> (port params, reference params, port opt, reference opt), all
    shapes only."""
    out = {}
    for arch in ALL_ARCHS:
        params = st.params_structs(get_config(arch))
        jparams = jst.params_structs(j_get_config(arch))
        out[arch] = (params, jparams, st.opt_structs(params), jst.opt_structs(jparams))
    return out


@pytest.mark.parametrize("arch", ALL_ARCHS)
def test_param_and_opt_specs_match_reference(meshes, structs, arch):
    name, jmesh, mesh = meshes
    params, jparams, opt, jopt = structs[arch]
    cfg, jcfg = get_config(arch), j_get_config(arch)
    for fsdp in (False, True):
        pspecs = shd.param_specs(cfg, params, mesh, fsdp=fsdp)
        jpspecs = jshd.param_specs(jcfg, jparams, jmesh, fsdp=fsdp)
        _held(pspecs, jpspecs, params)
        ospecs = shd.opt_specs(pspecs, opt)
        jospecs = jshd.opt_specs(jpspecs, jopt)
        _same(ospecs.step, jospecs.step)
        _held(ospecs.moments, jospecs.moments, opt.moments)


@pytest.mark.parametrize("arch", ALL_ARCHS)
def test_cache_specs_match_reference(meshes, arch):
    _, jmesh, mesh = meshes
    cfg, jcfg = get_config(arch), j_get_config(arch)
    for shape in INPUT_SHAPES.values():
        if shape.kind != "decode" or not st.supports_shape(cfg, shape)[0]:
            continue
        cache = st.cache_structs(cfg, shape)
        got = shd.cache_specs(cfg, cache, mesh, global_batch=shape.global_batch)
        want = jshd.cache_specs(jcfg, jst.cache_structs(jcfg, shape), jmesh,
                                global_batch=shape.global_batch)
        _held(got, want, cache)


@pytest.mark.parametrize("arch", ["internvl2_76b", "llama4_maverick_400b_a17b",
                                  "zamba2_2_7b", "seamless_m4t_large_v2", "llama3_8b",
                                  "mistral_7b"])
def test_shard_shapes_match_named_sharding(meshes, structs, arch):
    """Per-device shapes of params (fsdp), optimizer moments and every
    decode cache leaf against ``NamedSharding(...).shard_shape`` of the
    reference's stacked leaf, its stacked dim dropped."""
    _, jmesh, mesh = meshes
    params, jparams, opt, jopt = structs[arch]
    cfg, jcfg = get_config(arch), j_get_config(arch)
    pspecs = shd.param_specs(cfg, params, mesh, fsdp=True)
    jpspecs = jshd.param_specs(jcfg, jparams, jmesh, fsdp=True)
    trees = [(params, pspecs, jparams, jpspecs),
             (opt.moments, shd.opt_specs(pspecs, opt).moments, jopt.moments,
              jshd.opt_specs(jpspecs, jopt).moments)]
    shape = INPUT_SHAPES["decode_32k"]
    cache = st.cache_structs(cfg, shape)
    jcache = jst.cache_structs(jcfg, shape)
    trees.append((cache, shd.cache_specs(cfg, cache, mesh, global_batch=shape.global_batch),
                  jcache, jshd.cache_specs(jcfg, jcache, jmesh,
                                           global_batch=shape.global_batch)))
    for tree, specs, jtree, jspecs in trees:
        got = shd.shard_shapes(tree, specs, mesh)

        def check(path, x, n_stack, g):
            want = NamedSharding(jmesh, _ref_leaf(jspecs, path)).shard_shape(
                _ref_leaf(jtree, path).shape)
            assert g == (want[1:] if n_stack else want), path
        shd.walk(check, tree, got)


def test_shard_shape_refuses_an_axis_that_does_not_divide():
    mesh = make_production_mesh()
    assert shd.shard_shape((32, 64), sharding.P("data", "model"), mesh) == (2, 4)
    assert shd.shard_shape((512, 64, 3), sharding.P(("data", "model")), mesh) == (2, 64, 3)
    with pytest.raises(ValueError):
        shd.shard_shape((24,), sharding.P("data"), mesh)


@pytest.mark.parametrize("kind", ["train", "prefill", "decode"])
def test_needs_fsdp_matches_reference_at_equal_hbm(meshes, kind, monkeypatch):
    _, jmesh, mesh = meshes
    monkeypatch.setattr(shd, "HBM_PER_DEVICE", jshd.HBM_PER_CHIP)
    for arch in ALL_ARCHS:
        assert shd.needs_fsdp(get_config(arch), mesh, kind) == \
            jshd.needs_fsdp(j_get_config(arch), jmesh, kind), arch


def test_needs_fsdp_at_h100_memory(meshes):
    """At 80 GB a serving model goes weight-sharded when its TP-sharded bf16
    weights exceed 32 GB: on a TP axis of 16 only llama4_maverick; on one
    of 4 the ~70B+ models too; on one of 1 every model past 16B."""
    name, _, mesh = meshes
    assert shd.HBM_PER_DEVICE == 80e9
    want = {"pod16x16": {"llama4_maverick_400b_a17b"},
            "pod2x16x16": {"llama4_maverick_400b_a17b"},
            "host1x4": {"llama4_maverick_400b_a17b", "internvl2_76b", "llama31_70b"},
            "host4x1": {"llama4_maverick_400b_a17b", "internvl2_76b", "llama31_70b",
                        "yi_34b"}}[name]
    for kind in ("prefill", "decode"):
        assert {a for a in ALL_ARCHS
                if shd.needs_fsdp(get_config(a), mesh, kind)} == want
    assert all(shd.needs_fsdp(get_config(a), mesh, "train") for a in ALL_ARCHS)


def test_train_launcher_builds_its_step_on_a_host_mesh(monkeypatch, capsys):
    """launch/train.py passes a host mesh to build_train_step, as the
    reference's launcher: the CPU alone when asked for the CPU."""
    from repro_torch.launch import train
    seen = []
    build = st.build_train_step

    def spy(cfg, **kw):
        seen.append(kw["mesh"])
        return build(cfg, **kw)
    monkeypatch.setattr(st, "build_train_step", spy)
    out = train.main(["--arch", "mistral_7b", "--device", "cpu", "--steps", "1",
                      "--batch", "1", "--seq", "8"])
    (mesh,) = seen
    assert mesh.shape == {"data": 1, "model": 1} and mesh.devices == [torch.device("cpu")]
    assert "mesh {'data': 1, 'model': 1} (1 devices)" in capsys.readouterr().out
    assert np.isfinite(out["losses"][0])
