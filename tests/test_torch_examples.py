"""The port's five examples (``examples/torch_*.py``) on the CPU, against
the reference examples.

Each example's ``main(device="cpu")`` runs in process and its own
assertions hold. Where nothing that an example prints depends on the
weights or on JAX's random bits, its standard output equals the reference
example's line for line: the chain selection, the debt ledger and the
cluster simulation (host code), and the two serving examples (no request
has an EOS or stop token, so what they print is set by token counts and
prompts alone). The reference examples run in one subprocess on the JAX
package (``JAX_PLATFORMS=cpu PYTHONPATH=src``), started before the first
test and read by the tests that compare. The reference's DistAttention
demo is left out of that run: it fails on this JAX (``tests/
test_sharding.py::test_dist_attention_on_mesh`` fails for the same
reason). The port's DistAttention demo runs on one rank in process and on
8 gloo ranks (a 2 x 4 mesh, the KV sharded over 4 model ranks), its merge
error within DIST_TOL of ``dist_attention_ref``. Run with no arguments,
each example raises where there is no GPU: ``--device`` defaults to
``cuda`` and never falls back.
"""

import importlib.util
import os
import re
import signal
import socket
import subprocess
import sys

import pytest
import torch

ROOT = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..")
EXAMPLES = os.path.join(ROOT, "examples")
SRC = os.path.join(ROOT, "src")
NAMES = ("chain_nsga2", "distributed_kv_cluster", "quickstart",
         "serve_continuous_batching", "serve_shared_prefix")
LIMIT_S = 240  # each test's own time limit
SPAWN_TIMEOUT = 200
DIST_TOL = 1e-5
WORLD = 8
DIST_HEADER = "== DistAttention: sequence-sharded micro-attention =="

# the reference examples, one section each, in one process (the ledger and
# simulation demos without the DistAttention demo between them)
REFERENCE = """
import chain_nsga2, distributed_kv_cluster as dkv
import serve_continuous_batching, serve_shared_prefix
for name, fns in [("chain_nsga2", [chain_nsga2.main]),
                  ("distributed_kv_cluster", [dkv.debt_ledger_demo,
                                              dkv.cluster_sim_demo]),
                  ("serve_continuous_batching",
                   [serve_continuous_batching.main]),
                  ("serve_shared_prefix", [serve_shared_prefix.main])]:
    print("@@ " + name, flush=True)
    for fn in fns:
        fn()
"""


@pytest.fixture(autouse=True)
def time_limit():
    """A test that runs past LIMIT_S seconds fails instead of hanging; torch
    on one thread (beside other test processes a threaded BLAS
    oversubscribes the cores)."""
    def expire(signum, frame):
        raise TimeoutError(f"test ran past {LIMIT_S} s")
    old = signal.signal(signal.SIGALRM, expire)
    signal.alarm(LIMIT_S)
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)
    signal.alarm(0)
    signal.signal(signal.SIGALRM, old)


def _env(**kw):
    return dict(os.environ, PYTHONPATH=os.pathsep.join(
        [SRC, os.environ.get("PYTHONPATH", "")]), OMP_NUM_THREADS="1", **kw)


class _Reference:
    """The reference examples' stdout, by example; the process starts when
    the module's first test asks for it and is read on first use."""

    def __init__(self):
        self.proc = subprocess.Popen(
            [sys.executable, "-c", REFERENCE], cwd=EXAMPLES,
            env=_env(JAX_PLATFORMS="cpu", XLA_FLAGS=""),
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        self.sections = None

    def __getitem__(self, name):
        if self.sections is None:
            try:
                out, err = self.proc.communicate(timeout=SPAWN_TIMEOUT)
            except subprocess.TimeoutExpired:
                self.proc.kill()
                raise
            assert self.proc.returncode == 0, err[-3000:]
            self.sections = {}
            for part in out.split("@@ ")[1:]:
                head, _, body = part.partition("\n")
                self.sections[head] = body.splitlines()
        return self.sections[name]


@pytest.fixture(scope="module")
def reference():
    ref = _Reference()
    yield ref
    if ref.proc.poll() is None:
        ref.proc.kill()
        ref.proc.wait()


def _example(name):
    path = os.path.join(EXAMPLES, f"torch_{name}.py")
    spec = importlib.util.spec_from_file_location(f"torch_{name}", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def _without_dist_attention(lines, shards):
    """The port's distributed_kv_cluster output less its DistAttention
    demo (a blank line, the header, the error line)."""
    i = lines.index(DIST_HEADER)
    assert lines[i - 1] == ""
    assert re.fullmatch(rf"KV sharded over {shards} model shards; merge "
                        r"error vs unsharded oracle: \S+", lines[i + 1])
    return lines[:i - 1] + lines[i + 2:]


def test_quickstart_trains_checkpoints_and_serves(capsys):
    """120 training steps (the reference's assertion ``last < first -
    0.3`` inside), a checkpoint round trip in a temporary directory, 4
    prompts of 8 tokens served greedily for 8 new tokens each."""
    out = _example("quickstart").main(device="cpu")
    assert out["last_loss"] < out["first_loss"] - 0.3
    assert [len(t) for t in out["outputs"]] == [8] * 4
    assert all(0 <= t < 512 for toks in out["outputs"] for t in toks)
    assert out["pages_free"] == 128
    lines = capsys.readouterr().out.splitlines()
    assert lines[0] == "== training 120 steps on the synthetic corpus =="
    assert lines[-1] == "kv pages free: 128/128"


def test_chain_nsga2_prints_what_the_reference_prints(reference, capsys):
    out = _example("chain_nsga2").main(device="cpu")
    assert out["pareto"] > 1
    assert capsys.readouterr().out.splitlines() == reference["chain_nsga2"]


def test_distributed_kv_cluster_on_one_rank(reference, capsys):
    """The ledger and the simulation print what the reference's print;
    DistAttention on a one-rank gloo group (made and destroyed by the
    example) within DIST_TOL of the oracle."""
    import torch.distributed as dist
    out = _example("distributed_kv_cluster").main(device="cpu")
    assert not dist.is_initialized()
    assert out["dist_attention_err"] <= DIST_TOL
    assert out["ledger"]["ledger_entries"] == 1
    lines = _without_dist_attention(capsys.readouterr().out.splitlines(), 1)
    assert lines == reference["distributed_kv_cluster"]


@pytest.mark.parametrize("name", ["serve_continuous_batching",
                                  "serve_shared_prefix"])
def test_serving_example_prints_what_the_reference_prints(reference, capsys,
                                                          name):
    """Smoke danube on the port's engine: the requests' finishes,
    iterations, prefill and cache counts, pages and (shared prefix) the
    cold and cached engines' identical outputs, line for line."""
    out = _example(name).main(device="cpu")
    assert capsys.readouterr().out.splitlines() == reference[name]
    if name == "serve_shared_prefix":
        st = out["stats"]
        assert st["hit_tokens"] == 7 * 16 and st["lookup_tokens"] == 8 * 22
    else:
        assert out["n_finished"] == out["n_requests"] == 8
        assert out["pages_free"] == out["pages"]


def _free_port():
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


RANK_MAIN = """
import sys
sys.path.insert(0, sys.argv[1])
import torch_distributed_kv_cluster as m
print("ERR", repr(m.main(device="cpu")["dist_attention_err"]))
"""


def test_distributed_kv_cluster_on_eight_ranks(reference):
    """``main`` on 8 gloo ranks, as ``torchrun --nproc-per-node 8`` starts
    it: a 2 x 4 mesh, the KV sharded over 4 model ranks; every rank's merge
    error within DIST_TOL; rank 0 alone prints the ledger and the
    simulation, as the reference does."""
    port = _free_port()
    procs = [subprocess.Popen(
        [sys.executable, "-c", RANK_MAIN, EXAMPLES],
        env=_env(RANK=str(r), WORLD_SIZE=str(WORLD), LOCAL_RANK=str(r),
                 MASTER_ADDR="localhost", MASTER_PORT=str(port)),
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        for r in range(WORLD)]
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=SPAWN_TIMEOUT))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    assert all(p.returncode == 0 for p in procs), \
        [err[-2000:] for _, err in outs]
    for r, (out, _) in enumerate(outs):
        lines = out.splitlines()
        assert lines[-1].startswith("ERR ")
        assert float(lines[-1][4:]) <= DIST_TOL, (r, lines[-1])
        if r:
            assert lines == [lines[-1]]
    lines = _without_dist_attention(outs[0][0].splitlines()[:-1], 4)
    assert lines == reference["distributed_kv_cluster"]


@pytest.mark.parametrize("name", NAMES)
def test_example_refuses_to_run_without_a_gpu(name, monkeypatch):
    """``main()`` at its default device, and the script with no
    arguments, raise where there is no GPU: ``--device`` defaults to cuda
    and never falls back to the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        _example(name).main()
    run = subprocess.run(
        [sys.executable, os.path.join(EXAMPLES, f"torch_{name}.py")],
        env=_env(CUDA_VISIBLE_DEVICES=""), capture_output=True, text=True,
        timeout=SPAWN_TIMEOUT)
    assert run.returncode != 0
    assert "no CUDA device" in run.stderr
    assert not run.stdout
