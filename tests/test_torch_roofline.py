"""The port's roofline (``repro_torch.roofline.analysis``) and dry-run
(``repro_torch.launch.dryrun``) on the CPU.

``model_flops``, ``extrapolate`` and the input shapes equal the
reference's with ``==``. The dry-run's counts are checked in one
subprocess (it joins a fake process group of 8 ranks, a 2 x 4 mesh):
a single 2-D sharded matmul counts the local shard's FLOPs and the
gather and reduce-scatter bytes of the formula; a width whose heads do
not divide the ``model`` axis counts more per rank than ``model_flops /
chips``; each family's train step at smoke width lands where
recomputation puts it; and a production-mesh record (16 x 16, decode,
capped at 2 and 4 layers and extrapolated) is complete.
"""

import json
import os
import subprocess
import sys

import pytest

from repro.configs import INPUT_SHAPES as JAX_SHAPES
from repro.configs import get_config as jax_get_config
from repro.configs import input_specs as jax_input_specs
from repro.roofline import analysis as janalysis

from repro_torch.configs import ARCH_IDS, INPUT_SHAPES, get_config, \
    input_specs
from repro_torch.roofline import analysis

SRC = os.path.join(os.path.dirname(__file__), "..", "src")


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_model_flops_and_input_specs_match_reference(arch):
    cfg, jcfg = get_config(arch), jax_get_config(arch)
    assert list(INPUT_SHAPES) == list(JAX_SHAPES)
    for name, shape in INPUT_SHAPES.items():
        js = JAX_SHAPES[name]
        assert (shape.name, shape.seq_len, shape.global_batch, shape.kind) \
            == (js.name, js.seq_len, js.global_batch, js.kind)
        assert analysis.model_flops(cfg, shape) == \
            janalysis.model_flops(jcfg, js)
        got, want = input_specs(cfg, shape), jax_input_specs(jcfg, js)
        assert list(got) == list(want)
        for k in want:
            assert got[k].shape == want[k].shape
            assert str(got[k].dtype).split(".")[-1] == str(want[k].dtype)


def _pair(flops, byts, coll, chips):
    return (analysis.Roofline(flops, byts, float(sum(coll.values())),
                              dict(coll), chips),
            janalysis.Roofline(flops, byts, float(sum(coll.values())),
                               dict(coll), chips))


@pytest.mark.parametrize("l2,l4,l_full", [(2, 4, 24), (3, 5, 88), (4, 4, 4),
                                          (2, 4, 3)])
def test_extrapolate_matches_reference(l2, l4, l_full):
    a2, b2 = _pair(3.5e12, 7.25e11, {"all-gather": 1234567,
                                     "all-reduce": 89}, 256)
    a4, b4 = _pair(6.0e12, 9.5e11, {"all-gather": 2469134,
                                    "reduce-scatter": 10}, 256)
    got = analysis.extrapolate(a2, a4, l2, l4, l_full)
    want = janalysis.extrapolate(b2, b4, l2, l4, l_full)
    assert (got.flops, got.bytes_accessed, got.coll_bytes,
            got.coll_breakdown, got.chips) == \
        (want.flops, want.bytes_accessed, want.coll_bytes,
         want.coll_breakdown, want.chips)


def test_roofline_terms_are_the_h100s():
    """The data sheet's H100 SXM terms; the record's keys are the
    reference's."""
    assert (analysis.PEAK_FLOPS, analysis.HBM_BW, analysis.LINK_BW) == \
        (989e12, 3.35e12, 50e9)
    r, j = _pair(989e12, 3.35e12, {"all-reduce": 100e9}, 256)
    assert (r.t_compute, r.t_memory, r.t_collective) == (1.0, 1.0, 2.0)
    assert r.bottleneck == "collective"
    assert set(r.as_dict()) == set(j.as_dict())


SCRIPT = r'''
import json, sys, dataclasses, tempfile
import torch
from torch._subclasses.fake_tensor import FakeTensorMode
from torch.distributed.device_mesh import init_device_mesh
from torch.distributed.tensor import Replicate, Shard
from repro_torch.configs import InputShape, smoke_config
from repro_torch.launch import dryrun, sharding as shd
from repro_torch.roofline import analysis

out = {}
dryrun.join_fake_group(8)
mesh = init_device_mesh("cpu", (2, 4), mesh_dim_names=("data", "model"))
# one 2-D sharded matmul: x (8, 64, 256) over data, w (256, 512) stored
# (data, model), gathered to (-, model) forward, its gradient reduce-
# scattered back
with FakeTensorMode(allow_non_fake_inputs=True), \
        dryrun._unseen_shape_inference():
    x = shd.shard_tensor(torch.empty(8, 64, 256), mesh,
                         [Shard(0), Replicate()])
    w = shd.shard_tensor(torch.empty(256, 512), mesh,
                         [Shard(0), Shard(1)]).requires_grad_(True)
    g = shd.shard_tensor(torch.empty(8, 64, 512), mesh,
                         [Shard(0), Shard(2)])
    c = dryrun.Counter()
    with c:
        y = x @ w.redistribute(mesh, [Replicate(), Shard(1)])
        y.backward(g)
out["matmul"] = dict(flops=c.flops, coll=dict(c.collectives))
shape = InputShape("train_smoke", 256, 8, "train")
narrow = dataclasses.replace(smoke_config("h2o-danube-1.8b"), num_heads=6,
                             num_kv_heads=3)
fams = {a: smoke_config(a) for a in ("h2o-danube-1.8b", "deepseek-v2-236b",
                                      "hymba-1.5b")}
fams["6-heads"] = narrow
for name, cfg in fams.items():
    c, arg_b, _, secs = dryrun.count(cfg, shape, mesh)
    out[name] = dict(flops=c.flops, model=analysis.model_flops(cfg, shape),
                     bytes=c.bytes, coll=dict(c.collectives), secs=secs)
d = tempfile.mkdtemp()
rec = dryrun.run_one("h2o-danube-1.8b", "decode_32k", False, d,
                     verbose=False, cap=2)
out["record"] = rec
print("JSON " + json.dumps(out))
'''


@pytest.fixture(scope="module")
def counts():
    env = dict(os.environ, OMP_NUM_THREADS="1",
               PYTHONPATH=os.pathsep.join([SRC,
                                           os.environ.get("PYTHONPATH", "")]))
    r = subprocess.run([sys.executable, "-c", SCRIPT], env=env,
                       capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stdout[-3000:] + r.stderr[-3000:]
    line = [x for x in r.stdout.splitlines() if x.startswith("JSON ")][-1]
    return json.loads(line[5:])


def test_sharded_matmul_counts_the_local_shard(counts):
    """Forward and weight gradient of x (8 x 64 tokens, 2 data shards) @
    w (256 x 512, 4 model shards): each 2 x 256 x 256 x 128 FLOPs a rank
    (the global count would be 8 times that); the weight's gather over
    data outputs (256, 128) float32 and its gradient's reduce-scatter
    (128, 128)."""
    m = counts["matmul"]
    assert m["flops"] == 2 * (2 * 256 * 256 * 128)
    assert m["coll"] == {"all-gather": 256 * 128 * 4,
                         "reduce-scatter": 128 * 128 * 4}


def test_heads_that_do_not_divide_count_replicated_work(counts):
    """Six heads on a 4-way ``model`` axis stay whole on every rank: the
    rank counts more than its share of ``model_flops``."""
    r = counts["6-heads"]
    assert r["flops"] > r["model"] / 8


@pytest.mark.parametrize("name,lo,hi", [("h2o-danube-1.8b", 0.6, 0.75),
                                        ("hymba-1.5b", 0.6, 0.75),
                                        ("deepseek-v2-236b", 0.3, 0.5)])
def test_train_useful_flop_fraction(counts, name, lo, hi):
    """model_flops / chips over the counted FLOPs of a train step (8 x 256
    tokens, remat on): 6/8 of the matmul work at most (the forward runs
    twice), less the attention's own products (d_model 256 beside 256
    positions). The smoke MoE computes every expert's capacity of 4 x
    its even share (capacity factor 4, no drop), so half of that again."""
    r = counts[name]
    frac = r["model"] / 8 / r["flops"]
    assert lo <= frac <= hi, frac


def test_production_record_is_complete(counts):
    rec = counts["record"]
    assert rec["status"] == "ok" and rec["mesh"] == "16x16"
    roof = rec["roofline"]
    for k in ("flops_per_device", "bytes_per_device",
              "collective_bytes_per_device", "t_compute_s", "t_memory_s",
              "t_collective_s", "bottleneck"):
        assert k in roof
    assert roof["flops_per_device"] > 0 and roof["bytes_per_device"] > 0
    assert rec["hbm_per_device_gib"] > 0 and rec["fits_80gb"] is True
    assert 0 < rec["useful_flop_frac"] <= 1.0
    assert rec["layers_counted"] == [2, 4]


def test_roofline_report_reads_the_records(counts, tmp_path, capsys):
    """``benchmarks/torch_roofline_report.py`` over a directory holding the
    production record: one row, its terms the record's."""
    import importlib.util
    rec = counts["record"]
    (tmp_path / "r.json").write_text(json.dumps(rec))
    path = os.path.join(os.path.dirname(__file__), "..", "benchmarks",
                        "torch_roofline_report.py")
    spec = importlib.util.spec_from_file_location("torch_roofline_report",
                                                  path)
    rep = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(rep)
    rows = rep.run(str(tmp_path))
    assert len(rows) == 1 and rows[0]["status"] == "ok"
    assert rows[0]["t_comp"] == rec["roofline"]["t_compute_s"]
    assert "h2o-danube-1.8b" in capsys.readouterr().out
