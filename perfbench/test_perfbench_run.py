"""Whole runs of the harness on the CPU at a small size: what a later
change finds by name, the faults the correctness check has to catch, the
control in the program's place, and the command's refusal without a card.

The faults are planted in the timed path underneath a run (the engine the
window drives), and each must turn ``correct`` false: a decode step that
leaves the KV pools as they were (its state unchanged), half of the batch
left out with the mean of the rest in its place, and each sampled token
altered where it is produced. The cells run on one card, so there is no
exchange between cards to leave out.
"""

import copy
import hashlib
import json
import os
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from perfbench import host, tiny
from perfbench.harness import Bench, run_cell

HERE = Path(__file__).resolve().parent
SEED = 2 ** 31 + 77
QUIET = dict(device="cpu", log=lambda *a: None)


def _digest(root: Path):
    return {p.relative_to(root): hashlib.sha256(p.read_bytes()).hexdigest()
            for p in sorted(root.rglob("*")) if p.is_file()
            and "__pycache__" not in p.parts}


def test_a_new_metric_and_cell_are_found_by_name(tmp_path):
    before = _digest(HERE)
    root = tiny.tiny_root(tmp_path)
    copied = _digest(root / "perfbench")
    # a later change adds files and entries and edits no file
    (root / "perfbench/metrics/engine.polls_per_s.py").write_text(
        "def read(run):\n"
        "    ps = run.window_polls()\n"
        "    return len(ps) / (run.t_close - run.t_open) if ps else None\n")
    doc = json.loads((root / "BENCHMARK.json").read_text())
    doc["workloads"].append({"name": "tiny-dense.again",
                             "config": "tiny-dense", "traffic": "tiny",
                             "chips": 1, "why": "added later"})
    doc["per_layer"].append({"name": "engine.polls_per_s", "unit": "1/s",
                             "better": "higher", "source": "host_clock",
                             "layer": "engine", "moves": "tokens_per_s",
                             "workloads": ["tiny-dense.again"]})
    (root / "BENCHMARK.json").write_text(json.dumps(doc))
    bench = Bench(root)
    assert bench.cell("tiny-dense.again")["config"] == "tiny-dense"
    assert "engine.polls_per_s" in \
        [m["name"] for m in bench.metrics("tiny-dense.again", True)]
    assert "engine.polls_per_s" not in \
        [m["name"] for m in bench.metrics("tiny-dense.tiny", True)]
    out = run_cell(root, "tiny-dense.again", SEED, 1.0, True, **QUIET)
    assert out["correct"]
    assert out["metrics"]["engine.polls_per_s"]["value"] > 0
    assert out["metrics"]["engine.polls_per_s"]["unit"] == "1/s"
    after = _digest(root / "perfbench")
    assert all(after[k] == v for k, v in copied.items())
    assert _digest(HERE) == before  # nothing written into the checkout


def _keep_state(engine):
    """Each decode step's writes to the KV pools are undone."""
    decode = engine._decode

    def step(*a, **k):
        kp, vp = engine.k_pages.clone(), engine.v_pages.clone()
        out = decode(*a, **k)
        engine.k_pages.copy_(kp)
        engine.v_pages.copy_(vp)
        return out
    engine._decode = step


def _half_batch(engine):
    """The second half of the decode rows takes the mean of the first's
    logits."""
    decode = engine._decode

    def step(*a, **k):
        logits = decode(*a, **k)
        n = logits.shape[0]
        logits[n // 2:] = logits[:n // 2].mean(0)
        return logits
    engine._decode = step


def _alter_tokens(engine):
    """Every sampled token is replaced by the next id."""
    sample = engine._sample_rows

    def rows(logits, reqs):
        toks, lps = sample(logits, reqs)
        return (toks + 1) % engine.cfg.vocab_size, lps
    engine._sample_rows = rows


@pytest.mark.parametrize("fault", [None, _keep_state, _half_batch,
                                   _alter_tokens],
                         ids=["sound", "state_unchanged", "half_batch",
                              "token_altered"])
@pytest.mark.parametrize("cell", ["tiny-dense.tiny", "tiny-mla.tiny"])
def test_planted_faults_turn_correct_false(tmp_path, cell, fault):
    root = tiny.tiny_root(tmp_path)
    out = run_cell(root, cell, SEED, 1.0, False, hooks=fault, **QUIET)
    assert out["correct"] is (fault is None), out["check"]
    assert list(out)[-1] == "check"


# The control at a size a test holds: the stand-ins in bf16 at width 256
# and a vocabulary of 2,048, 400 served tokens compared, each statistic a
# committed configuration compares (OPT's mean squared gap on the dense
# stand-in, DeepSeek's mean gap on the MLA + MoE one) and the dense mean.
# Over ten seeds (2 s windows, one thread) the program read at most
# 1.2e-4 / 1.1e-6 (dense, mean / mean square) and 4.6e-3 (MLA + MoE,
# mean), the control at least 3.2e-3 / 1.2e-4 and 2.7e-2; each limit lies
# between (PERF.md, section 2). The control is judged by the run's own
# comparison, with the configuration's limits.
CONTROL_CASES = [
    pytest.param(tiny.DENSE, "mean_logit_gap", 5e-4, id="tiny-dense-0.0005"),
    pytest.param(tiny.MLA, "mean_logit_gap", 8e-3, id="tiny-mla-0.008"),
    pytest.param(tiny.DENSE, "msq_logit_gap", 1e-5,
                 id="tiny-dense-msq_logit_gap-1e-05"),
]


@pytest.mark.parametrize("conf,stat,limit", CONTROL_CASES)
def test_the_control_fails_where_the_program_passes(tmp_path, conf, stat,
                                                    limit):
    conf = tiny.widen(tiny.bf16(conf), 256, 2048, 400)
    conf["check"]["limits"] = {stat: limit}
    root = tiny.tiny_root(tmp_path, confs=(conf,))
    out = run_cell(root, conf["name"] + ".tiny", 5, 2.0, False,
                   control=True, **QUIET)
    assert out["correct"], out["check"]
    assert out["control_correct"] is False, out["control_readings"]
    assert out["control_readings"][stat] > limit


def test_committed_statistics_are_those_the_control_test_holds():
    held = {p.values[1] for p in CONTROL_CASES}
    bench = Bench(HERE.parent)
    for c in bench.doc["configs"]:
        assert set(bench.config(c["name"])["check"]["limits"]) <= held


def test_host_settings_pin_the_engine_thread_for_the_traffic(tmp_path):
    if not hasattr(os, "sched_setaffinity"):
        pytest.skip("no CPU affinity on this platform")
    conf = copy.deepcopy(tiny.DENSE)
    conf["host"] = {"intra_op_threads": 1, "engine_core": "last"}
    root = tiny.tiny_root(tmp_path, confs=(conf,))
    assert host.settings(root, "tiny-dense.tiny") == conf["host"]
    before = os.sched_getaffinity(0)
    seen = []

    def spy(engine):
        decode = engine._decode

        def step(*a, **k):
            seen.append(os.sched_getaffinity(0))
            return decode(*a, **k)
        engine._decode = step

    out = run_cell(root, "tiny-dense.tiny", SEED, 1.0, False, hooks=spy,
                   **QUIET)
    assert out["correct"], out["check"]
    assert seen and {max(before)} in seen
    assert os.sched_getaffinity(0) == before


def test_host_settings_set_the_thread_count(monkeypatch):
    for var in host.THREAD_VARS:
        monkeypatch.delenv(var, raising=False)
    host.set_thread_env({})
    assert not any(v in os.environ for v in host.THREAD_VARS)
    host.set_thread_env({"intra_op_threads": 1})
    assert all(os.environ[v] == "1" for v in host.THREAD_VARS)


def test_the_command_refuses_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the command would run")
    proc = subprocess.run(
        [sys.executable, str(HERE / "run.py"), "--workload",
         "opt13b.chat64", "--seed", "1", "--seconds", "1", "--trace", "0"],
        capture_output=True, text=True, timeout=120, cwd=HERE.parent)
    assert proc.returncode != 0
    assert proc.stdout.strip() == ""


def test_benchmark_names_what_exists():
    bench = Bench(HERE.parent)
    doc = bench.doc
    for c in doc["configs"]:
        conf = json.loads((HERE.parent / c["file"]).read_text())
        assert conf["name"] == c["name"]
        assert sorted(conf["reduced"]) == sorted(c["reduced"])
        assert (HERE / "reference" / f"{conf['reference']}.py").exists()
    for m in doc["per_layer"]:
        assert (HERE / "metrics" / f"{m['name']}.py").exists(), m["name"]
        assert m["moves"] in [e["name"] for e in doc["end_to_end"]]
    for w in doc["workloads"]:
        assert (HERE / "traffic" / f"{w['traffic']}.json").exists()


def test_configs_match_the_port():
    from perfbench.harness import port_config
    bench = Bench(HERE.parent)
    for c in bench.doc["configs"]:
        conf = copy.deepcopy(bench.config(c["name"]))
        cfg = port_config(conf)
        assert cfg.num_layers == conf["num_hidden_layers"]
