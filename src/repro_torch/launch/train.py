"""Training launcher: the training loop on any assigned arch (counterpart of
``repro/launch/train.py``, with its flags).

PYTHONPATH=src python -m repro_torch.launch.train --arch llama3.2-3b --steps 50             # on the GPU
PYTHONPATH=src python -m repro_torch.launch.train --device cpu --steps 4 --ckpt-dir /tmp/ck

The model is the reduced config of ``--arch`` (``models.reduced``: d_model
64, 2 layers, vocab 256, f32), or with ``--full-size`` the published one,
from ``init_params(cfg, seed=0)`` on ``--device``; batches come from the
Markov corpus (seed 0) through ``data.batch_iterator``, frame embeddings
for an embeddings-input model. The step is ``train.make_train_step`` (remat,
AdamW at ``--lr``, ``--accum`` microbatches), run by ``train.loop.train_loop``
with a checkpoint every quarter of ``--steps`` in ``--ckpt-dir``: a rerun
with the same directory resumes from its newest checkpoint, and SIGTERM /
SIGINT writes a final checkpoint and exits. ``--log-every`` sets how often
a step's loss and wall are printed (the reference prints every 10th).
"""

from __future__ import annotations

import argparse
from typing import Callable, Optional, Sequence

import torch

from repro_torch.configs import ARCH_IDS, get_config
from repro_torch.data import MarkovCorpus, batch_iterator
from repro_torch.models import init_params, reduced
from repro_torch.train import adamw_init, make_train_step
from repro_torch.train.loop import LoopConfig, PreemptionGuard, train_loop
from repro_torch.utils import resolve_device


def parse_args(argv: Optional[Sequence[str]] = None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--arch", choices=ARCH_IDS, default="llama3.2-3b")
    ap.add_argument("--steps", type=int, default=50)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=64)
    ap.add_argument("--lr", type=float, default=1e-3)
    ap.add_argument("--accum", type=int, default=1)
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--full-size", action="store_true", help="use the published config")
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    ap.add_argument("--log-every", type=int, default=10)
    return ap.parse_args(argv)


def main(argv: Optional[Sequence[str]] = None, *, log: Callable[[str], None] = print):
    """Run the CLI → (cfg, params, opt_state, history); ``log`` takes the
    loop's lines (a step's loss and wall, ``[straggler]``, ``[restore]``,
    ``[preempt]``)."""
    args = parse_args(argv)
    device = resolve_device(args.device)
    cfg = get_config(args.arch) if args.full_size else reduced(get_config(args.arch))
    params = init_params(cfg, seed=0, device=device)
    opt = adamw_init(params)
    step = make_train_step(cfg, lr=args.lr, accum_steps=args.accum)
    corpus = MarkovCorpus(cfg.vocab, seed=0)
    emb = cfg.d_model if cfg.input_kind == "embeddings" else None
    batches = (
        {k: torch.from_numpy(v).to(device) for k, v in b.items()}
        for b in batch_iterator(corpus, batch=args.batch, seq_len=args.seq, embed_dim=emb)
    )
    loop_cfg = LoopConfig(total_steps=args.steps, ckpt_dir=args.ckpt_dir,
                          ckpt_every=max(args.steps // 4, 1), log_every=args.log_every)
    params, opt, history = train_loop(step, params, opt, batches, loop_cfg, log=log, guard=PreemptionGuard())
    return cfg, params, opt, history


if __name__ == "__main__":
    main()
