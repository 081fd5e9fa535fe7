"""Training launcher: arch selection, elasticity, checkpoint/restart (the
port of ``repro.launch.train``).

    PYTHONPATH=src python -m repro_torch.launch.train --arch qwen2-7b \\
        --steps 100 --reduced --ckpt /path/to/ckpt
    PYTHONPATH=src python -m repro_torch.launch.train --reduced --device cpu

The JAX launcher's flags, plus ``--device`` (default: the card; it raises
without CUDA).  On a cluster this process runs once per host:
``--coordinator HOST:PORT`` joins ``--hosts`` processes as rank ``--host``
of a gloo process group over ``tcp://`` (where the JAX launcher calls
``jax.distributed.initialize``).  The data shard of each step is a pure
function of (seed, step, healthy hosts), so an elastic restart resumes
the same global sample sequence (``train/elastic.py``).
"""
from __future__ import annotations

import argparse
import dataclasses


def main(argv: list[str] | None = None) -> list[dict]:
    ap = argparse.ArgumentParser(description="repro_torch training launcher")
    ap.add_argument("--arch", default="qwen2-7b")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--seq", type=int, default=64)
    ap.add_argument("--global-batch", type=int, default=16)
    ap.add_argument("--vocab", type=int, default=256)
    ap.add_argument("--lr", type=float, default=1e-3)
    ap.add_argument("--microbatches", type=int, default=1)
    ap.add_argument("--ckpt", default=None)
    ap.add_argument("--reduced", action="store_true",
                    help="reduced config (CPU-runnable smoke scale)")
    ap.add_argument("--host", type=int, default=0)
    ap.add_argument("--hosts", type=int, default=1)
    ap.add_argument("--coordinator", default=None,
                    help="HOST:PORT of rank 0's gloo rendezvous (multi-host)")
    ap.add_argument("--device", default=None,
                    help="torch device (default: cuda)")
    args = ap.parse_args(argv)

    if args.coordinator:
        import torch.distributed as dist

        addr = args.coordinator
        dist.init_process_group(
            "gloo", init_method=addr if "://" in addr else f"tcp://{addr}",
            world_size=args.hosts, rank=args.host)
        try:
            return _train(args)
        finally:
            dist.destroy_process_group()
    return _train(args)


def _train(args) -> list[dict]:
    from ..configs import get_arch
    from ..train import AdamW, DataConfig, TokenSource, Trainer

    cfg = get_arch(args.arch)
    if args.reduced:
        cfg = dataclasses.replace(cfg.reduced(), vocab_size=args.vocab)
    data = TokenSource(DataConfig(
        vocab_size=cfg.vocab_size, seq_len=args.seq,
        global_batch=args.global_batch, kind="markov",
    ))
    tr = Trainer(
        cfg, AdamW(lr=args.lr, warmup=min(20, args.steps // 5),
                   total_steps=args.steps),
        data, ckpt_dir=args.ckpt, microbatches=args.microbatches,
        log_every=10, ckpt_every=50, device=args.device,
    )
    print(f"arch={cfg.name} steps={args.steps} resume_at={tr.step_idx} "
          f"loss_floor={data.entropy_rate():.3f}")
    hist = tr.run(
        max(args.steps - tr.step_idx, 0),
        host=args.host,
        healthy=list(range(args.hosts)),
    )
    tr.finish()
    for h in hist:
        print(f"step {h['step']:6d}  loss {h['loss']:.4f}  lr {h['lr']:.2e}  "
              f"{h['sec_per_step']:.2f}s")
    return hist

if __name__ == "__main__":
    main()
