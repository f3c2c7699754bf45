"""The port's training loss curve beside the JAX package's, on the CPU.

    PYTHONPATH=src python tests/torch_loss_curve.py --d-model 2560 --layers 2

h2o-danube-1.8b's plan at a chosen width and depth (heads of 64, a quarter
of them KV heads, d_ff 2.7 d, the vocabulary of 32,000), one weight tree
(the reference's ``Model.init``, carried over by the bridge), the train
launcher's optimizer settings (peak lr ``--lr``, warm-up 5 steps, cosine
over ``--steps``) and the synthetic corpus's 8 x 256-token batches: each
step runs the reference's jitted ``make_train_step`` and the port's, and
prints both losses and gradient norms. A script, not a test (pytest does
not collect it): at full width a step takes seconds on the CPU. It shows
whether a loss curve of the port, such as the card's, is the reference's
own: the two curves are expected to track each other within the bf16
rounding differences of ``tests/test_torch_training.py``.
"""

import argparse
import dataclasses
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))

from repro.configs import get_config  # noqa: E402
from repro.models import Model as JaxModel  # noqa: E402
from repro.training import optimizer as jopt  # noqa: E402
from repro.training.data import DataConfig, SyntheticCorpus  # noqa: E402
from repro.training.train_loop import make_train_step as jax_step  # noqa

from repro_torch.bridge import from_numpy_tree  # noqa: E402
from repro_torch.configs import ArchConfig  # noqa: E402
from repro_torch.models.transformer import Model  # noqa: E402
from repro_torch.training import optimizer  # noqa: E402
from repro_torch.training.train_loop import batch_to  # noqa: E402
from repro_torch.training.train_loop import make_train_step  # noqa: E402


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--d-model", type=int, default=512)
    ap.add_argument("--layers", type=int, default=4)
    ap.add_argument("--steps", type=int, default=10)
    ap.add_argument("--lr", type=float, default=1e-3)
    ap.add_argument("--dtype", default="bfloat16")
    args = ap.parse_args(argv)
    d = args.d_model
    jcfg = dataclasses.replace(
        get_config("h2o-danube-1.8b"), d_model=d, num_layers=args.layers,
        num_heads=d // 64, num_kv_heads=max(d // 256, 1), head_dim=64,
        d_ff=int(d * 2.7), dtype=args.dtype)
    jm = JaxModel(jcfg, remat=False)
    jp = jm.init(jax.random.PRNGKey(0))
    tp = from_numpy_tree(jax.tree.map(np.asarray, jp))
    ocfg = dict(lr=args.lr, warmup_steps=5, total_steps=args.steps)
    jstep = jax.jit(jax_step(jm, jopt.OptConfig(**ocfg)))
    tstep = make_train_step(Model(ArchConfig(**dataclasses.asdict(jcfg))),
                            optimizer.OptConfig(**ocfg))
    js, ts = jopt.init(jp), optimizer.init(tp)
    corpus = SyntheticCorpus(DataConfig(vocab_size=jcfg.vocab_size,
                                        seq_len=256, global_batch=8))
    print(f"d_model {d}, {args.layers} layers, {jcfg.num_heads} heads / "
          f"{jcfg.num_kv_heads} KV, d_ff {jcfg.d_ff}, {args.dtype}, peak "
          f"lr {args.lr}")
    for i, batch in zip(range(args.steps), corpus.batches()):
        jp, js, jmet = jstep(jp, js, {k: jnp.asarray(v)
                                      for k, v in batch.items()})
        tp, ts, tmet = tstep(tp, ts, batch_to(batch, "cpu"))
        print(f"step {i}: reference loss {float(jmet['loss']):.4f} gnorm "
              f"{float(jmet['grad_norm']):.3f} | port loss "
              f"{float(tmet['loss']):.4f} gnorm "
              f"{float(tmet['grad_norm']):.3f}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
