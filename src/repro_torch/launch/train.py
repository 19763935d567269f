"""Training launcher: the end-to-end entry point with async checkpointing,
heartbeat and straggler monitoring and resume.

The port of ``repro.launch.train`` on one device:

    PYTHONPATH=src python -m repro_torch.launch.train --arch h2o-danube-3-4b \\
        --smoke --steps 20

It trains on the CUDA device unless ``--device cpu`` names the CPU (no
fallback: without a card it stops).  ``--smoke`` takes the arch's reduced
config at 4 sequences of 64 tokens, two microbatches and float32 moments;
otherwise the published config at the shape's batch and length, eight
microbatches and int8 moments (the reference's two ``TrainConfig``s).  The
printed lines are the reference's.  On ``--resume`` the data stream skips
the batches the checkpoint's steps consumed, so a resumed run repeats the
uninterrupted one (the reference's restarts its stream at the first
batch).  ``main(argv)`` returns the last step's metrics.
"""
from __future__ import annotations

import argparse
import itertools
import os
import tempfile
import time

import torch

from repro_torch.common import default_device
from repro_torch.configs import get_config, get_shape, get_smoke_config
from repro_torch.configs.base import ShapeConfig, TrainConfig
from repro_torch.data.pipeline import Prefetcher, synthetic_batches
from repro_torch.ft.checkpoint import Checkpointer
from repro_torch.ft.health import HealthMonitor
from repro_torch.models import build_model
from repro_torch.training import Trainer


def main(argv=None):
    ap = argparse.ArgumentParser(
        description="Train a zoo model on one device: the CUDA card unless "
                    "--device cpu.")
    ap.add_argument("--arch", default="internlm2-20b")
    ap.add_argument("--shape", default="train_4k")
    ap.add_argument("--smoke", action="store_true",
                    help="reduced config + tiny shapes")
    ap.add_argument("--steps", type=int, default=20)
    ap.add_argument("--ckpt-every", type=int, default=10)
    ap.add_argument("--ckpt-dir",
                    default=os.path.join(tempfile.gettempdir(),
                                         "repro_torch_ckpt"))
    ap.add_argument("--resume", action="store_true")
    ap.add_argument("--batch", type=int, default=0)
    ap.add_argument("--seq", type=int, default=0)
    ap.add_argument("--device", default=None,
                    help="torch device to train on (default: cuda; the CPU "
                         "only when named: --device cpu)")
    args = ap.parse_args(argv)

    device = default_device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise SystemExit("no CUDA device: pass --device cpu to train on the "
                         "CPU")
    cfg = get_smoke_config(args.arch) if args.smoke else get_config(args.arch)
    shape = get_shape(args.shape)
    b = args.batch or (4 if args.smoke else shape.global_batch)
    s = args.seq or (64 if args.smoke else shape.seq_len)
    shape = ShapeConfig(shape.name, s, b, shape.kind)

    model = build_model(cfg)
    tcfg = TrainConfig(microbatches=2 if args.smoke else 8,
                       moment_dtype="fp32" if args.smoke else "int8")
    trainer = Trainer(model, tcfg)
    ckpt = Checkpointer(args.ckpt_dir)
    mon = HealthMonitor(n_units=1)

    state = trainer.init_state(0, device)
    start_step = 0
    if args.resume and ckpt.latest_step() is not None:
        state, start_step = ckpt.restore(state)
        print(f"resumed from step {start_step}")

    data = Prefetcher(itertools.islice(
        synthetic_batches(cfg, shape, batch_override=b, seq_override=s),
        start_step, None), device)
    t_all = time.time()
    last = None
    try:
        for step in range(start_step, args.steps):
            t0 = time.time()
            batch = next(data)
            state, metrics = trainer.train_step(state, batch)
            last = {k: float(v) for k, v in metrics.items()}  # waits
            dt = time.time() - t0
            mon.record_step(dt)
            mon.beat(0)
            if step % 5 == 0 or step == args.steps - 1:
                print(f"step {step}: loss {last['loss']:.4f} "
                      f"gnorm {last['grad_norm']:.2f} {dt:.2f}s"
                      + ("  [straggler]" if mon.is_straggler(dt) else ""))
            if (step + 1) % args.ckpt_every == 0:
                ckpt.save(step + 1, state)          # async
        ckpt.save(args.steps, state, blocking=True)
    finally:
        data.close()
    print(f"done: {args.steps - start_step} steps in {time.time()-t_all:.1f}s; "
          f"checkpoints at {args.ckpt_dir}")
    return last


if __name__ == "__main__":
    main()
