"""The port's dry-run and roofline against the JAX package's.

  * ``SHAPES``, ``cells_for``, ``ASSIGNED`` and ``VARIANTS`` equal JAX's;
    ``batch_shapes`` and ``input_specs`` give JAX's shapes, dtypes and specs
    for every config on both production meshes;
  * ``model_flops`` equals JAX's for every assigned arch and cell, and
    ``analyze_record`` equals JAX's on the same records with the port's H100
    constants patched to the reference's v5e ones;
  * the folded sLSTM loop counts the loop's FLOPs exactly;
  * held against JAX's compiled dry-run: one JAX subprocess on 8 fake
    devices lowers and compiles smoke cells (danube, bert-large, xlstm,
    deepseek; train, prefill and decode at 8 × 64) on a 2 × 2 host mesh with
    ``unroll=True`` (the accounting the port's eager count gives) and writes
    one JSON file; the port's records at the same cells hold argument and
    output bytes exactly (each difference explained), FLOPs within 10 % of
    each cell's own measured ratio to XLA's, and collective bytes per kind
    as stated in each test;
  * the per-device split of every such cell follows JAX's param specs,
    exactly.

No test draws at random: every case is enumerated.
"""

import collections
import json
import os
import subprocess
import sys
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")

from repro.compat import abstract_mesh  # noqa: E402
from repro.configs import ASSIGNED as J_ASSIGNED  # noqa: E402
from repro.configs import REGISTRY as J_REGISTRY  # noqa: E402
from repro.configs import SHAPES as J_SHAPES  # noqa: E402
from repro.configs import cells_for as j_cells_for  # noqa: E402
from repro.configs import get_config as jget_config  # noqa: E402
from repro.configs import get_smoke_config as jax_smoke_config  # noqa: E402
from repro.launch import roofline as jroof  # noqa: E402
from repro.launch import steps as jsteps  # noqa: E402
from repro.sharding import policy as jpol  # noqa: E402
from repro_torch.configs import ASSIGNED, REGISTRY, SHAPES, cells_for  # noqa: E402
from repro_torch.configs import get_smoke_config  # noqa: E402
from jax_twin import twin_config  # noqa: E402
from repro_torch.configs.shapes import ShapeSpec  # noqa: E402
from repro_torch.launch import dryrun as tdry  # noqa: E402
from repro_torch.launch import mesh as tmesh  # noqa: E402
from repro_torch.launch import roofline as troof  # noqa: E402
from repro_torch.launch import steps as tsteps  # noqa: E402
from repro_torch.models import transformer as ttf  # noqa: E402
from repro_torch.sharding import policy as tpol  # noqa: E402
from repro_torch.bridge import flatten_with_paths  # noqa: E402
from repro_torch.tree import leaves  # noqa: E402

SRC = str(Path(__file__).resolve().parents[1] / "src")
ARCHS = ("h2o-danube-1.8b", "bert-large", "xlstm-125m", "deepseek-v2-lite-16b")
SMOKE_SHAPES = {"train_4k": ("train", 64, 8), "prefill_32k": ("prefill", 64, 8),
                "decode_32k": ("decode", 64, 8)}
CELLS = [(a, s) for a in ARCHS for s in SMOKE_SHAPES]
JAX_MESHES = {"single": abstract_mesh((16, 16), ("data", "model")),
              "multi": abstract_mesh((2, 16, 16), ("pod", "data", "model"))}
#: port FLOPs / XLA FLOPs per device at each smoke cell, as measured (jax
#: 0.9.0's CPU backend, 2 × 2 host mesh). ``FlopCounterMode`` counts matmuls,
#: attention and convolutions only; XLA's cost analysis also counts every
#: elementwise op, reduction and transcendental, so the port counts less,
#: most at decode, where the matmuls are smallest (bert-large decode: 0.564).
#: Above 1 only where XLA fuses away work the eager program runs (xlstm's
#: train and decode). Each cell is held within ``FLOP_RTOL`` of its own
#: ratio: a per-device split off by a factor of 2 moves a ratio by 50 % or
#: 100 %, far outside it.
FLOP_RATIOS = {
    "h2o-danube-1.8b/train_4k": 0.820, "h2o-danube-1.8b/prefill_32k": 0.897,
    "h2o-danube-1.8b/decode_32k": 0.717,
    "bert-large/train_4k": 0.923, "bert-large/prefill_32k": 0.876,
    "bert-large/decode_32k": 0.564,
    "xlstm-125m/train_4k": 1.012, "xlstm-125m/prefill_32k": 0.952,
    "xlstm-125m/decode_32k": 1.077,
    "deepseek-v2-lite-16b/train_4k": 0.745, "deepseek-v2-lite-16b/prefill_32k": 0.817,
    "deepseek-v2-lite-16b/decode_32k": 0.824,
}
FLOP_RTOL = 0.10

JAX_DRYRUN = r"""
import json, os, sys
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
sys.path.insert(0, {src!r})
from repro.configs import get_smoke_config
from repro.configs.shapes import ShapeSpec
from repro.launch import dryrun
from repro.launch.mesh import make_host_mesh
dryrun.get_config = get_smoke_config
dryrun.SHAPES = {{k: ShapeSpec(k, *v) for k, v in {shapes!r}.items()}}
dryrun.make_production_mesh = lambda multi_pod=False: make_host_mesh(2, 2)
out = {{}}
for arch, shape in {cells!r}:
    rec = dryrun.run_cell(arch, shape, "single", unroll=True, save=False)
    assert rec["ok"], rec.get("traceback")
    out[arch + "/" + shape] = {{k: rec[k] for k in ("memory", "cost", "collectives")}}
with open({path!r}, "w") as f:
    json.dump(out, f)
"""


@pytest.fixture(scope="module", autouse=True)
def _jax_dryrun(tmp_path_factory):
    """Starts JAX's dry-run with the module's first test, so that it
    overlaps the tests before the ones that read it."""
    path = tmp_path_factory.mktemp("dryrun") / "jax_records.json"
    env = {k: v for k, v in os.environ.items() if k != "XLA_FLAGS"}
    code = JAX_DRYRUN.format(src=SRC, shapes=SMOKE_SHAPES, cells=CELLS, path=str(path))
    proc = subprocess.Popen([sys.executable, "-c", code], stdout=subprocess.PIPE,
                            stderr=subprocess.PIPE, text=True, env=env)
    yield proc, path
    if proc.poll() is None:
        proc.kill()
    proc.communicate()


@pytest.fixture(scope="module")
def jax_records(_jax_dryrun):
    proc, path = _jax_dryrun
    _, err = proc.communicate(timeout=600)
    assert proc.returncode == 0, err[-3000:]
    return json.loads(path.read_text())


@pytest.fixture(scope="module")
def port_records():
    """The port's records at the same smoke cells, on a 2 × 2 mesh shape."""
    saved = (tdry.get_config, tdry.SHAPES, tdry.make_production_mesh)
    tdry.get_config = get_smoke_config
    tdry.SHAPES = {k: ShapeSpec(k, *v) for k, v in SMOKE_SHAPES.items()}
    tdry.make_production_mesh = lambda multi_pod=False: tpol.MeshShape(("data", "model"),
                                                                       (2, 2))
    try:
        out = {}
        for arch, shape in CELLS:
            rec = tdry.run_cell(arch, shape, "single", save=False)
            assert rec["ok"], rec.get("traceback")
            cell = tdry.build_cell(arch, shape, tdry.make_production_mesh())
            rec["n_outputs"] = len(leaves(cell["outs"]))
            out[f"{arch}/{shape}"] = rec
        return out
    finally:
        tdry.get_config, tdry.SHAPES, tdry.make_production_mesh = saved


def _pspec(spec) -> tuple:
    return tuple(spec)


# ---------------------------------------------------------------------------
# shapes, cells and specs
# ---------------------------------------------------------------------------

def test_shapes_cells_and_assigned_equal_jax():
    assert {k: (v.name, v.step, v.seq_len, v.global_batch) for k, v in SHAPES.items()} == \
        {k: (v.name, v.step, v.seq_len, v.global_batch) for k, v in J_SHAPES.items()}
    assert ASSIGNED == J_ASSIGNED and len(ASSIGNED) == 10
    assert sorted(REGISTRY) == sorted(J_REGISTRY)
    for arch in sorted(REGISTRY):
        assert cells_for(twin_config(arch)) == j_cells_for(jget_config(arch)), arch


def test_variants_equal_jax():
    flags = os.environ.get("XLA_FLAGS")
    try:
        from repro.launch import dryrun as jdry  # its import sets XLA_FLAGS
    finally:
        if flags is None:
            os.environ.pop("XLA_FLAGS", None)
        else:
            os.environ["XLA_FLAGS"] = flags
    assert tdry.VARIANTS == jdry.VARIANTS


@pytest.mark.parametrize("mesh", ["single", "multi"])
@pytest.mark.parametrize("arch", sorted(REGISTRY))
def test_batch_shapes_and_input_specs_equal_jax(arch, mesh):
    jmesh = JAX_MESHES[mesh]
    tmesh_ = tmesh.make_production_mesh(multi_pod=(mesh == "multi"))
    for name, shape in SHAPES.items():
        for replicate in (False, True):
            jp = jpol.make_policy(jget_config(arch), jmesh, replicate_batch=replicate)
            tp = tpol.make_policy(twin_config(arch), tmesh_, replicate_batch=replicate)
            jshapes = jsteps.batch_shapes(jget_config(arch), shape.seq_len, shape.global_batch)
            tshapes, tspecs = tsteps.input_specs(twin_config(arch), tp, shape.seq_len,
                                                 shape.global_batch)
            assert sorted(tshapes) == sorted(jshapes), (arch, name)
            for k, j in jshapes.items():
                t = tshapes[k]
                assert t.device.type == "meta"
                assert tuple(t.shape) == tuple(j.shape), (arch, name, k)
                assert str(t.dtype).removeprefix("torch.") == str(j.dtype), (arch, name, k)
            jspecs = jp.batch_specs(jshapes)
            assert {k: tuple(v) for k, v in tspecs.items()} == \
                {k: _pspec(v) for k, v in jspecs.items()}, (arch, name, replicate)
            assert tsteps.batch_shapes(twin_config(arch), shape.seq_len,
                                       shape.global_batch).keys() == tshapes.keys()


def test_sharded_struct_is_each_device_share():
    mesh = tmesh.make_production_mesh(multi_pod=True)  # pod 2, data 16, model 16
    t = torch.empty((64, 48, 3), dtype=torch.bfloat16, device="meta")
    dev = tsteps.sharded_struct(t, (("pod", "data"), "model", None), mesh)
    assert tuple(dev.shape) == (2, 3, 3) and dev.dtype == torch.bfloat16
    assert tsteps.shard_shape((5, 7), ("data", None), mesh) == (1, 7)  # rounded up
    tree = {"a": [t, t], "b": t}
    specs = {"a": [(None, "model", None), ("data", None, None)], "b": (None, None, None)}
    out = tsteps.sharded_struct(tree, specs, mesh)
    assert [tuple(x.shape) for x in leaves(out)] == [(64, 3, 3), (4, 48, 3), (64, 48, 3)]


# ---------------------------------------------------------------------------
# the roofline
# ---------------------------------------------------------------------------

def test_model_flops_equal_jax():
    for arch in ASSIGNED:
        for shape in cells_for(twin_config(arch)):
            assert troof.model_flops(arch, shape) == jroof.model_flops(arch, shape), \
                (arch, shape)


def _record(arch: str, shape: str, i: int, mesh: str = "single") -> dict:
    """A record in the JAX schema with enumerated numbers (no draws)."""
    return {"arch": arch, "shape": shape, "mesh": mesh, "n_devices": 256 if mesh == "single"
            else 512, "ok": True, "unroll": False, "comm": "xla", "compress": False,
            "variant": "", "memory": {"argument_bytes": 10 ** 9, "output_bytes": 10 ** 9,
                                      "temp_bytes": (i + 1) * 3 * 10 ** 8, "alias_bytes": 0},
            "cost": {"flops": 1.5e12 * (i + 1) ** 2, "bytes_accessed": 7.0e9 * (i % 5 + 1)},
            "collectives": {"all-reduce": {"count": i, "bytes": 2 ** 20 * i * (i % 3)},
                            "all-gather": {"count": 0, "bytes": 0},
                            "total_bytes": 2 ** 20 * i * (i % 3), "total_count": i}}


def test_analyze_record_equals_jax_with_jax_constants(monkeypatch):
    monkeypatch.setattr(troof, "PEAK_FLOPS", {"bfloat16": jroof.PEAK_FLOPS,
                                              "float32": jroof.PEAK_FLOPS})
    monkeypatch.setattr(troof, "HBM_BW", jroof.HBM_BW)
    monkeypatch.setattr(troof, "LINK_BW", jroof.ICI_BW)
    i = over = 0
    for arch in ASSIGNED:
        for shape in cells_for(twin_config(arch)):
            for mesh in ("single", "multi"):
                rec = _record(arch, shape, i, mesh)
                i += 1
                j, t = jroof.analyze_record(rec), troof.analyze_record(rec)
                over += t["roofline_frac"] > 1
                t["roofline_frac"] = min(t["roofline_frac"], 1.0)  # JAX caps it; the port not
                for k, v in j.items():
                    assert t[k] == v, (arch, shape, k)
    assert i == 2 * sum(len(cells_for(twin_config(a))) for a in ASSIGNED)
    assert 0 < over < i  # some of these records have a count below the model's FLOPs


def test_roofline_frac_is_not_capped_and_is_flagged():
    """A record whose count falls below the model's FLOPs reads above 1;
    the table flags it and ``over_bound`` names it."""
    low = _record("h2o-danube-1.8b", "prefill_32k", 0)
    low["collectives"]["total_bytes"] = 0
    low["cost"]["bytes_accessed"] = 1.0
    row = troof.analyze_record(low)
    expect = troof.model_flops("h2o-danube-1.8b", "prefill_32k") / low["cost"]["flops"] / 256
    assert expect > 1 and row["dominant"] == "compute"
    assert row["roofline_frac"] == pytest.approx(expect, rel=1e-12)
    assert troof.over_bound([row]) == ["h2o-danube-1.8b/prefill_32k/single"]
    assert troof.OVER_FLAG in troof.to_markdown([row])
    high = dict(low, cost={"flops": 1e30, "bytes_accessed": 1.0})
    row = troof.analyze_record(high)
    assert row["roofline_frac"] < 1 and troof.over_bound([row]) == []
    assert troof.OVER_FLAG not in troof.to_markdown([row])


def test_roofline_uses_h100_constants_and_names_the_link():
    from repro_torch.core.cost_model import PAPER_LINK_BW
    assert troof.PEAK_FLOPS == {"bfloat16": 989e12, "float32": 67e12}
    assert troof.HBM_BW == 3.35e12 and troof.LINK_BW == PAPER_LINK_BW == 300e9
    rec = _record("h2o-danube-1.8b", "train_4k", 3)
    row = troof.analyze_record(rec)
    assert row["t_compute_s"] == rec["cost"]["flops"] / 989e12
    assert row["t_collective_s"] == rec["collectives"]["total_bytes"] / 300e9
    rec["memory"]["temp_bytes"] = None  # the port's records
    assert troof.analyze_record(rec)["temp_gb"] is None
    assert "PAPER_LINK_BW" in troof.constants() and "989" in troof.constants()


def test_roofline_main_reads_the_port_records(tmp_path, monkeypatch, capsys):
    """One row per single-mesh cell; records of another mesh or of a
    variant are left out; the constants line names the link constant."""
    monkeypatch.setattr(troof, "DRYRUN_DIR", tmp_path / "dryrun_torch")
    monkeypatch.setattr(troof, "EXP_DIR", tmp_path)
    (tmp_path / "dryrun_torch").mkdir()
    cells = [(a, s) for a in ASSIGNED for s in cells_for(twin_config(a))]
    for i, (arch, shape) in enumerate(cells):
        for mesh in ("single", "multi"):
            (tmp_path / "dryrun_torch" / f"{arch}__{shape}__{mesh}.json").write_text(
                json.dumps(_record(arch, shape, i, mesh)))
    (tmp_path / "dryrun_torch" / "glm4-9b__train_4k__single__mb4.json").write_text(
        json.dumps(dict(_record("glm4-9b", "train_4k", 0), variant="mb4")))
    rows = troof.main(["--mesh", "single"])
    out = capsys.readouterr().out
    assert len(rows) == len(cells) and {r["mesh"] for r in rows} == {"single"}
    assert "PAPER_LINK_BW" in out.splitlines()[0]
    md = (tmp_path / "roofline_torch_single.md").read_text()
    assert md.count("\n") == len(cells) + 2
    assert len(json.loads((tmp_path / "roofline_torch_single.json").read_text())) == len(cells)
    assert sum(troof.dominant_counts(rows).values()) == len(cells)


# ---------------------------------------------------------------------------
# counting
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("variant", ["", "noremat", "mb4"])
def test_folded_slstm_loop_counts_the_loop_exactly(variant):
    """xlstm at smoke width, S = 24: the folded loop's FLOPs equal the full
    loop's per (stage, block), forward, backward and remat. Its bytes fall
    short by the loop's per-step additions of the two gradients that reach
    each h_t (from the output and from step t + 1), which the fold runs
    once: 8–10 % of a training step's bytes here; at prefill, only the
    read of the step that stands for the later ones (< 1 %)."""
    mesh = tpol.MeshShape(("data", "model"), (2, 2))
    saved = (tdry.get_config, tdry.SHAPES)
    tdry.get_config = get_smoke_config
    tdry.SHAPES = {"train_4k": ShapeSpec("train_4k", "train", 24, 4),
                   "prefill_32k": ShapeSpec("prefill_32k", "prefill", 24, 4)}
    try:
        for shape in tdry.SHAPES:
            cell = tdry.build_cell("xlstm-125m", shape, mesh, variant=variant)
            scopes = tdry.param_scopes(cell["cfg"], cell["params"])
            folded = tdry.count_step(cell["run"], cell["params"], scopes, fold_scan=True)
            loop = tdry.count_step(cell["run"], cell["params"], scopes, fold_scan=False)
            assert folded["flops"] == loop["flops"], (variant, shape)
            assert folded["global_flops"] == loop["global_flops"] > 0
            assert folded["folds"] > 0 and loop["folds"] == 0
            fb, lb = sum(folded["bytes"].values()), sum(loop["bytes"].values())
            assert 0.88 * lb <= fb <= lb, (variant, shape, fb, lb)
            if shape == "prefill_32k":  # only the stand-in outputs are read once
                assert fb >= 0.99 * lb
    finally:
        tdry.get_config, tdry.SHAPES = saved


@pytest.mark.parametrize("arch", ["h2o-danube-1.8b", "deepseek-v2-lite-16b", "zamba2-1.2b"])
def test_folded_chunk_loops_count_the_loop_exactly(arch):
    """The chunked attention (GQA with a window; MLA) and mamba2's
    chunk-state scan (zamba2) at smoke width with chunks of 8: S = 40 (five
    full chunks) and S = 44 (a ragged tail of 4). At prefill the folded
    loops count the full loops' FLOPs per (stage, block) and their bytes,
    exactly; a training step (S = 40), where they do not fold, counts the
    same."""
    mesh = tpol.MeshShape(("data", "model"), (2, 2))
    saved = (tdry.get_config, tdry.SHAPES)
    tdry.get_config = lambda a: get_smoke_config(a).replace(dense_attn_limit=0, attn_chunk=8,
                                                            ssm_chunk=8)
    try:
        for s, shape in ((40, "prefill_32k"), (44, "prefill_32k"), (40, "train_4k")):
            tdry.SHAPES = {shape: ShapeSpec(shape, shape.split("_")[0], s, 4)}
            cell = tdry.build_cell(arch, shape, mesh)
            scopes = tdry.param_scopes(cell["cfg"], cell["params"])
            folded = tdry.count_step(cell["run"], cell["params"], scopes, fold_scan=True)
            loop = tdry.count_step(cell["run"], cell["params"], scopes, fold_scan=False)
            assert folded["flops"] == loop["flops"], (s, shape)
            assert folded["global_flops"] == loop["global_flops"] > 0
            assert folded["bytes"] == loop["bytes"], (s, shape)
            cfg = cell["cfg"]  # one fold per attention or mamba2 layer, at prefill
            loops = cfg.n_layers + sum(ttf._shared_site(cfg, i) for i in range(cfg.n_layers))
            assert folded["folds"] == (loops if shape == "prefill_32k" else 0)
            assert loop["folds"] == 0
    finally:
        tdry.get_config, tdry.SHAPES = saved


def test_counts_split_over_the_mesh():
    """On a 1 × 1 mesh every device does all the work; on 2 × 2 danube's
    prefill (every block TP-sharded, the vocabulary divides) splits four
    ways, and its final norm's work only over the data axis."""
    saved = (tdry.get_config, tdry.SHAPES)
    tdry.get_config = get_smoke_config
    tdry.SHAPES = {"prefill_32k": ShapeSpec("prefill_32k", "prefill", 64, 8)}
    try:
        one = tpol.MeshShape(("data", "model"), (1, 1))
        four = tpol.MeshShape(("data", "model"), (2, 2))
        cell = tdry.build_cell("h2o-danube-1.8b", "prefill_32k", one)
        counts = tdry.count_step(cell["run"], cell["params"],
                                 tdry.param_scopes(cell["cfg"], cell["params"]))
        f1, b1 = tdry.split_per_device(counts, cell["cfg"], cell["policy"], cell["shape"])
        assert f1 == counts["global_flops"] == sum(counts["flops"].values())
        cell4 = tdry.build_cell("h2o-danube-1.8b", "prefill_32k", four)
        f4, b4 = tdry.split_per_device(counts, cell4["cfg"], cell4["policy"], cell4["shape"])
        assert f4 == f1 / 4
        other = sum(v for (_, s), v in counts["bytes"].items() if s == "other")
        assert other > 0 and b4 == pytest.approx((b1 - other) / 4 + other / 2, rel=1e-12)
        assert {s for _, s in counts["flops"]} == {"dense", "vocab"}
    finally:
        tdry.get_config, tdry.SHAPES = saved


@pytest.mark.parametrize("cell", [f"{a}/{s}" for a, s in CELLS])
def test_split_per_device_follows_the_jax_specs(cell, port_records):
    """Every smoke cell on the 2 × 2 mesh, exactly: each (stage, block)'s
    global count is divided by the data axis (the batch of 8 splits two
    ways; the optimizer stage over ZeRO-1's data axis) and by the model axis
    where JAX's param specs shard a leaf of that block over it; a block
    whose leaves JAX replicates is not divided over it. On 1 × 1 nothing is
    divided."""
    arch, shape = cell.split("/")
    saved = (tdry.get_config, tdry.SHAPES)
    tdry.get_config = get_smoke_config
    tdry.SHAPES = {k: ShapeSpec(k, *v) for k, v in SMOKE_SHAPES.items()}
    try:
        cells = {m: tdry.build_cell(arch, shape, tpol.MeshShape(("data", "model"), (m, m)))
                 for m in (1, 2)}
    finally:
        tdry.get_config, tdry.SHAPES = saved
    c1, c2 = cells[1], cells[2]
    counts = tdry.cell_counts(c2, (repr(c2["cfg"]), c2["shape"], ""))  # port_records' count
    f1, b1 = tdry.split_per_device(counts, c1["cfg"], c1["policy"], c1["shape"])
    assert f1 == counts["global_flops"] and b1 == sum(counts["bytes"].values())
    jp = jpol.make_policy(jax_smoke_config(arch), abstract_mesh((2, 2), ("data", "model")))
    scopes = tdry.param_scopes(c2["cfg"], c2["params"])
    on_model = collections.defaultdict(bool)
    for path, leaf in flatten_with_paths(c2["params"]):
        spec = jp.param_spec(path, tuple(leaf.shape))
        on_model[scopes[path]] |= any("model" in tsteps.entry_axes(e) for e in spec)
    assert on_model, cell
    expect = {"flops": 0.0, "bytes": 0.0}
    for table in expect:
        for (stage, scope), v in counts[table].items():
            expect[table] += v / (2 * (2 if on_model[scope] else 1))
    f2, b2 = tdry.split_per_device(counts, c2["cfg"], c2["policy"], c2["shape"])
    assert f2 == pytest.approx(expect["flops"], rel=1e-12), cell
    assert b2 == pytest.approx(expect["bytes"], rel=1e-12), cell
    assert f2 == port_records[cell]["cost"]["flops"]


@pytest.mark.parametrize("variant", sorted(tdry.VARIANTS))
def test_every_variant_runs_at_smoke(variant):
    saved = (tdry.get_config, tdry.SHAPES, tdry.make_production_mesh)
    tdry.get_config = get_smoke_config
    tdry.SHAPES = {k: ShapeSpec(k, *v) for k, v in SMOKE_SHAPES.items()}
    tdry.make_production_mesh = lambda multi_pod=False: tpol.MeshShape(
        ("pod", "data", "model") if multi_pod else ("data", "model"),
        (2, 2, 2) if multi_pod else (2, 2))
    try:
        for shape in SMOKE_SHAPES:
            for mesh in ("single", "multi"):
                rec = tdry.run_cell("h2o-danube-1.8b", shape, mesh, save=False, variant=variant)
                assert rec["ok"], rec.get("traceback")
                assert rec["memory"]["temp_bytes"] is None and rec["memory"]["temp_bytes_note"]
                assert rec["cost"]["flops"] > 0 and rec["n_devices"] == (8 if mesh == "multi"
                                                                         else 4)
    finally:
        tdry.get_config, tdry.SHAPES, tdry.make_production_mesh = saved


# ---------------------------------------------------------------------------
# against JAX's compiled dry-run
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("cell", [f"{a}/{s}" for a, s in CELLS])
def test_argument_and_output_bytes_equal_jax(cell, jax_records, port_records):
    """Argument bytes are equal, but for one argument ``jax.jit`` drops:
    xlstm's decode never reads the position, and ``jit``'s ``keep_unused=False``
    leaves its 4 bytes out. Output bytes are equal once XLA's output table is
    counted: a program with n > 1 outputs adds 8 bytes per output (jit of n
    f32[4] outputs reports 16·n + 8·n bytes on this backend)."""
    j, t = jax_records[cell]["memory"], port_records[cell]
    unused = 4 if cell == "xlstm-125m/decode_32k" else 0
    assert j["argument_bytes"] == t["memory"]["argument_bytes"] - unused
    n = t["n_outputs"]
    assert j["output_bytes"] == t["memory"]["output_bytes"] + (8 * n if n > 1 else 0)
    assert j["alias_bytes"] == t["memory"]["alias_bytes"]


@pytest.mark.parametrize("cell", [f"{a}/{s}" for a, s in CELLS])
def test_flops_within_band_of_jax(cell, jax_records, port_records):
    j = jax_records[cell]["cost"]["flops"]
    t = port_records[cell]["cost"]["flops"]
    assert t / j == pytest.approx(FLOP_RATIOS[cell], rel=FLOP_RTOL), (cell, t / j)


@pytest.mark.parametrize("cell", [f"{a}/{s}" for a, s in CELLS])
def test_collective_bytes_per_kind_against_jax(cell, jax_records, port_records):
    """Per kind, as the specs let one say it:

      * an activation all-reduce of TP (or of the vocab-sharded embedding)
        at prefill and decode: the same count, and twice the port's bytes,
        because XLA's CPU backend promotes the bf16 all-reduce to f32 (its
        HLO's ``to_apply=…clone_promoted``). Not for deepseek (XLA moves its
        MoE tokens by all-to-all, gathers and permutes) or xlstm's decode
        (XLA gathers the replicated mixers' state);
      * training: ZeRO-1's all-gather of the updated shards is every
        param shard, in JAX as in the port, exactly; not for deepseek,
        whose MoE adds XLA gathers (JAX's is then larger). XLA partitions a
        training step's activations its own way (few activation
        all-reduces), so the port's all-reduce bytes, gradients plus TP,
        bound JAX's from above, and its gradient all-reduce alone from below
        where XLA all-reduces gradients (danube, bert-large).
    """
    j, t = jax_records[cell]["collectives"], port_records[cell]
    tc, src = t["collectives"], t["collective_sources"]
    arch, shape = cell.split("/")
    moe = arch == "deepseek-v2-lite-16b"
    if shape != "train_4k":
        if moe or cell == "xlstm-125m/decode_32k":
            assert j["all-reduce"]["count"] >= tc["all-reduce"]["count"]
            return
        assert j["all-reduce"]["count"] == tc["all-reduce"]["count"] > 0
        assert j["all-reduce"]["bytes"] == 2 * tc["all-reduce"]["bytes"]
        assert j["all-gather"]["count"] == tc["all-gather"]["count"] == 0
        return
    if moe:
        assert j["all-gather"]["bytes"] >= src["zero"] == tc["all-gather"]["bytes"]
    else:
        assert j["all-gather"]["bytes"] == src["zero"] == tc["all-gather"]["bytes"]
    assert j["all-reduce"]["bytes"] <= tc["all-reduce"]["bytes"]
    if arch in ("h2o-danube-1.8b", "bert-large"):
        assert j["all-reduce"]["bytes"] >= src["gradients"]
