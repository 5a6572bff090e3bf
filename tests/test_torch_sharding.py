"""The port's sharding policy against the JAX package's, spec for spec.

The JAX policy runs on ``AbstractMesh``es of the production shapes (as
tests/test_sharding_policy.py builds them), the port's on
``launch.mesh.make_production_mesh``'s ``MeshShape``s; neither needs a
device. For every config the port registers, on the single and multi
meshes:

  * every parameter and optimizer spec, with ZeRO-3 as ``make_policy``
    decides it, forced on and forced off, and with ``flat_dp``; the
    port's specs divide their leaves (``check_divides``);
  * every cache spec of the smoke configs' bf16 and int8 (KIVI) cache
    trees at ``init_caches(cfg, 128, 2048)``, with and without ``flat_dp``;
  * batch specs, with and without ``replicate_batch``;
  * ``derive_tp``, ``collective_profile`` and ``zoo_profiles`` field for
    field;
  * ``to_placements``: one DTensor placement per mesh axis, and a DTensor
    built from them on a one-rank gloo mesh.

A spec entry is compared as the PartitionSpec's own entry (``None``, an
axis name, or a tuple of names).
"""

import dataclasses
import functools

import jax
import pytest
from jax.sharding import PartitionSpec as P

torch = pytest.importorskip("torch")

from repro.compat import abstract_mesh  # noqa: E402
from repro.configs import REGISTRY as JAX_REGISTRY  # noqa: E402
from repro.configs import get_config as jget_config  # noqa: E402
from repro.configs import get_smoke_config as jget_smoke  # noqa: E402
from repro.launch import steps as jsteps  # noqa: E402
from repro.models import transformer as jtf  # noqa: E402
from repro.sharding import policy as jpol  # noqa: E402
from repro_torch.bridge import flatten_with_paths  # noqa: E402
from repro_torch.configs import REGISTRY, get_config, get_smoke_config  # noqa: E402
from repro_torch.launch import mesh as tmesh  # noqa: E402
from repro_torch.launch import steps as tsteps  # noqa: E402
from repro_torch.models import transformer as ttf  # noqa: E402
from repro_torch.sharding import policy as tpol  # noqa: E402

ARCHS = sorted(REGISTRY)
JAX_MESHES = {"single": abstract_mesh((16, 16), ("data", "model")),
              "multi": abstract_mesh((2, 16, 16), ("pod", "data", "model"))}
VARIANTS = {"auto": {}, "zero3": {"zero3": True}, "no_zero3": {"zero3": False},
            "flat_dp": {"flat_dp": True}}


def _mesh(name):
    return JAX_MESHES[name], tmesh.make_production_mesh(multi_pod=(name == "multi"))


@functools.lru_cache(maxsize=None)
def _jax_shapes(arch):
    """The reference's param and optimizer shape trees."""
    params = jtf.param_shapes(jget_config(arch))
    return params, jsteps.opt_shapes(jget_config(arch), params)


def _spec_leaves(tree):
    """A spec tree's leaves in path order (dict keys sorted; a spec tuple,
    or a PartitionSpec, is a leaf)."""
    if isinstance(tree, dict):
        return [s for k in sorted(tree) for s in _spec_leaves(tree[k])]
    if isinstance(tree, list):
        return [s for v in tree for s in _spec_leaves(v)]
    return [tuple(tree)]


def _same_specs(jspecs, tspecs, paths, what):
    jl, tl = _spec_leaves(jspecs), _spec_leaves(tspecs)
    assert len(jl) == len(tl) == len(paths), what
    for path, j, t in zip(paths, jl, tl):
        assert t == j, (what, path, t, j)


def test_registry_and_active_params_match():
    assert sorted(JAX_REGISTRY) == ARCHS
    for arch in ARCHS:
        assert get_config(arch).active_param_count() == jget_config(arch).active_param_count()


@pytest.mark.parametrize("variant", list(VARIANTS))
@pytest.mark.parametrize("mesh", ["single", "multi"])
@pytest.mark.parametrize("arch", ARCHS)
def test_param_and_opt_specs_match_jax(arch, mesh, variant):
    jmesh, tm = _mesh(mesh)
    kw = VARIANTS[variant]
    jp = jpol.make_policy(jget_config(arch), jmesh, **kw)
    tp = tpol.make_policy(get_config(arch), tm, **kw)
    assert (tp.tp, tp.dp, tp.zero3, tp.dp_entry, dataclasses.astuple(tp.axes)) == \
        (jp.tp, jp.dp, jp.zero3, jp.dp_entry, dataclasses.astuple(jp.axes))
    jparams, jopt = _jax_shapes(arch)
    tparams = ttf.param_shapes(get_config(arch))
    topt = tsteps.opt_shapes(get_config(arch), tparams)
    for what, jtree, ttree, jspecs, tspecs in (
            ("param", jparams, tparams, jp.param_specs, tp.param_specs),
            ("opt", jopt, topt, jp.opt_specs, tp.opt_specs)):
        got = flatten_with_paths(ttree)
        assert [(k, tuple(t.shape), t.dtype.itemsize) for k, t in got] == \
            [(k, tuple(s.shape), s.dtype.itemsize) for k, s in flatten_with_paths(jtree)]
        assert {str(t.device) for _, t in got} == {"meta"}  # nothing allocated
        _same_specs(jspecs(jtree), tspecs(ttree), [k for k, _ in got], what)
    if variant == "auto":  # the trainer's check: every spec divides its leaf
        tp.check_divides(tparams, tp.param_spec)
        tp.check_divides(topt, tp.opt_spec)


def test_zero3_auto_for_dbrx_only_and_check_divides_names_the_leaf():
    for arch in ARCHS:
        policy = tpol.make_policy(get_config(arch), tmesh.make_production_mesh())
        assert policy.zero3 == (arch == "dbrx-132b"), arch
    policy = tpol.make_policy(get_config("bert-large"), tpol.MeshShape(("data", "model"), (1, 3)))
    shapes = ttf.param_shapes(get_config("bert-large"))
    with pytest.raises(ValueError, match="segments/0/mlp/wi: dim 2 .* 'model'"):
        policy.check_divides(shapes, policy.param_spec)


@pytest.mark.parametrize("flat_dp", [False, True])
@pytest.mark.parametrize("kv", ["bf16", "int8"])
@pytest.mark.parametrize("mesh", ["single", "multi"])
def test_cache_specs_match_jax(mesh, kv, flat_dp):
    jmesh, tm = _mesh(mesh)
    for arch in ARCHS:
        over = {"kv_cache_dtype": "int8"} if kv == "int8" else {}
        jcfg, tcfg = jget_smoke(arch).replace(**over), get_smoke_config(arch).replace(**over)
        jshapes = jax.eval_shape(lambda: jtf.init_caches(jcfg, 128, 2048))
        tshapes = ttf.init_caches(tcfg, 128, 2048, device="meta")
        flat = flatten_with_paths(tshapes)
        assert [(k, tuple(t.shape), str(t.dtype).split(".")[-1]) for k, t in flat] == \
            [(k, tuple(s.shape), str(s.dtype)) for k, s in flatten_with_paths(jshapes)], arch
        if kv == "int8" and "dense" in tcfg.block_pattern and tcfg.kind != "encdec":
            assert any(k.endswith("k_scale") for k, _ in flat), arch
        jp = jpol.make_policy(jcfg, jmesh, flat_dp=flat_dp)
        tp = tpol.make_policy(tcfg, tm, flat_dp=flat_dp)
        _same_specs(jp.cache_specs(jshapes), tp.cache_specs(tshapes), [k for k, _ in flat],
                    f"{arch} cache")


@pytest.mark.parametrize("replicate", [False, True])
@pytest.mark.parametrize("mesh", ["single", "multi"])
def test_batch_specs_match_jax(mesh, replicate):
    jmesh, tm = _mesh(mesh)
    for arch in ARCHS:
        jcfg, tcfg = jget_config(arch), get_config(arch)
        jp = jpol.make_policy(jcfg, jmesh, replicate_batch=replicate)
        tp = tpol.make_policy(tcfg, tm, replicate_batch=replicate)
        for batch, seq in ((256, 4096), (1, 524288), (48, 128)):
            jshapes = jsteps.batch_shapes(jcfg, seq, batch)
            tshapes = {k: torch.empty(v.shape, device="meta") for k, v in jshapes.items()}
            jspecs, tspecs = jp.batch_specs(jshapes), tp.batch_specs(tshapes)
            assert {k: tuple(v) for k, v in jspecs.items()} == tspecs, (arch, batch)
    assert tpol.make_policy(get_config("zamba2-1.2b"), tm).batch_spec(
        "tokens", (1, 524288)) == tuple(P(None, None))


def test_derive_tp_and_collective_profiles_match_jax():
    for arch in ARCHS:
        jcfg, tcfg = jget_config(arch), get_config(arch)
        for tp in (1, 2, 4, 8, 16):
            assert tpol._tp_sharded_fraction(tcfg, tp) == jpol._tp_sharded_fraction(jcfg, tp)
            for kind in set(tcfg.block_pattern):
                assert tpol._block_tp_sharded(tcfg, kind, tp) == \
                    jpol._block_tp_sharded(jcfg, kind, tp)
        assert tpol.derive_tp(tcfg) == jpol.derive_tp(jcfg), arch
        assert tpol.derive_tp(tcfg, 4, 80e9) == jpol.derive_tp(jcfg, 4, 80e9), arch
        for kw in ({}, {"tp": 2}, {"dtype_bytes": 4, "cadence": 3},
                   {"bucket_bytes": 25 << 20, "max_buckets": 64}):
            assert dataclasses.asdict(tpol.collective_profile(tcfg, **kw)) == \
                dataclasses.asdict(jpol.collective_profile(jcfg, **kw)), (arch, kw)
    zoo_t, zoo_j = tpol.zoo_profiles(), jpol.zoo_profiles()
    assert list(zoo_t) == list(zoo_j) == ARCHS
    assert {k: dataclasses.asdict(v) for k, v in zoo_t.items()} == \
        {k: dataclasses.asdict(v) for k, v in zoo_j.items()}
    from repro_torch.sim.workload import CollectiveProfile
    with pytest.raises(ValueError, match="tp and cadence"):
        CollectiveProfile(model="x", tp=0)
    with pytest.raises(ValueError, match="bucket sizes"):
        CollectiveProfile(model="x", buckets=(1.0, 0.0))


def test_production_meshes_and_data_axes():
    for name, (jmesh, tm) in ((n, _mesh(n)) for n in JAX_MESHES):
        assert tm.axis_names == tuple(jmesh.axis_names)
        assert tm.axis_sizes == tuple(jmesh.axis_sizes)
        assert tmesh.data_axes(tm) == (("pod", "data") if name == "multi" else ("data",))
    virtual = tmesh.make_host_mesh(4, "cpu")
    assert virtual.shape == {"data": 4, "model": 1} and tmesh.data_axes(virtual) == ("data",)
    policy = tpol.make_policy(get_config("bert-large"), virtual)
    assert (policy.tp, policy.dp, policy.zero3) == (1, 4, False)


def test_to_placements_builds_a_dtensor(tmp_path):
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh
    from torch.distributed.tensor import Replicate, Shard, distribute_tensor

    policy = tpol.make_policy(get_config("bert-large"), tmesh.make_production_mesh(multi_pod=True))
    spec = policy.opt_spec("m/segments/0/mlp/wi", (24, 1024, 4096))
    assert spec == (None, ("pod", "data"), "model")
    placements = tpol.to_placements(spec, ("pod", "data", "model"))
    assert placements == [Shard(1), Shard(1), Shard(2)]
    assert tpol.to_placements((None, "model"), ("data", "model")) == [Replicate(), Shard(1)]
    with pytest.raises(ValueError, match="lacks"):
        tpol.to_placements(("pod", None), ("data", "model"))
    dist.init_process_group("gloo", init_method=f"file://{tmp_path / 'rdv'}", world_size=1,
                            rank=0)
    try:
        mesh = init_device_mesh("cpu", (1, 1), mesh_dim_names=("data", "model"))
        shape = tpol.MeshShape(mesh.mesh_dim_names, tuple(mesh.shape))
        spec = tpol.make_policy(get_config("bert-large"), shape).param_spec(
            "segments/0/attn/wq", (2, 8, 4, 16))
        placements = tpol.to_placements(spec, mesh.mesh_dim_names)
        assert len(placements) == 2 and placements == [Replicate(), Shard(2)]
        full = torch.arange(2 * 8 * 4 * 16, dtype=torch.float32).reshape(2, 8, 4, 16)
        dt = distribute_tensor(full, mesh, placements)
        assert tuple(dt.placements) == tuple(placements)
        assert torch.equal(dt.full_tensor(), full)
    finally:
        dist.destroy_process_group()
