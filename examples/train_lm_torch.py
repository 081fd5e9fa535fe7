"""End-to-end training on the PyTorch port: train a reduced config for a
few hundred steps on synthetic Markov data, with checkpoint/restart (the
port's counterpart of ``examples/train_lm.py``).

    PYTHONPATH=src python examples/train_lm_torch.py --arch qwen2-7b --steps 200
    PYTHONPATH=src python examples/train_lm_torch.py --device cpu

The loss converges toward the data's conditional entropy (printed).  Kill
and re-run with the same --ckpt to see resume-by-manifest; the
checkpoints are the JAX package's format, so either example resumes the
other's run.  ``main`` returns the logged history.
"""
import argparse
import os
import sys
import tempfile

os.environ.setdefault("OMP_NUM_THREADS", "1")
sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "src"))


def main(argv=None) -> list:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--arch", default="qwen2-7b")
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--seq", type=int, default=64)
    ap.add_argument("--batch", type=int, default=16)
    ap.add_argument("--vocab", type=int, default=256)
    ap.add_argument("--lr", type=float, default=1e-3)
    ap.add_argument("--ckpt", default=os.path.join(tempfile.gettempdir(),
                                                   "repro_train_ckpt"))
    ap.add_argument("--layers", type=int, default=4)
    ap.add_argument("--device", default=None,
                    help="torch device (default: cuda)")
    args = ap.parse_args(argv)

    from repro_torch.configs import get_arch
    from repro_torch.models import param_count
    from repro_torch.train import AdamW, DataConfig, TokenSource, Trainer

    cfg = get_arch(args.arch).reduced(
        num_layers=max(args.layers, get_arch(args.arch).scan_unit),
        vocab_size=args.vocab, d_model=256, d_ff=512, num_heads=8,
        num_kv_heads=4, head_dim=32,
    )
    data = TokenSource(DataConfig(vocab_size=args.vocab, seq_len=args.seq,
                                  global_batch=args.batch, kind="markov"))
    print(f"arch={cfg.name} (reduced) | loss floor (entropy rate) = "
          f"{data.entropy_rate():.3f} nats")
    tr = Trainer(cfg, AdamW(lr=args.lr, warmup=20, total_steps=args.steps),
                 data, ckpt_dir=args.ckpt, log_every=10, ckpt_every=50,
                 device=args.device)
    print(f"params: {param_count(tr.params):,} on {tr.device} | "
          f"resuming at step {tr.step_idx}")
    hist = tr.run(args.steps - tr.step_idx)
    tr.finish()
    for h in hist:
        print(f"step {h['step']:5d}  loss {h['loss']:.4f}  "
              f"gnorm {h['grad_norm']:.2f}  {h['sec_per_step']:.2f}s/step")
    return hist


if __name__ == "__main__":
    main()
