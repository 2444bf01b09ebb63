"""End-to-end driver on the PyTorch/CUDA port: train a ~100M-parameter LM
for a few hundred steps.  The port of ``examples/train_lm.py``.

The launcher's whole path on one device: weights drawn from a seed,
the train step, async checkpoints, the straggler watchdog, exact resume
from ``--ckpt-dir`` (a second run on the same directory resumes from the
first's last checkpoint).  ``--device cpu`` runs on the CPU (the
default, ``cuda``, raises without a card).

  PYTHONPATH=src python examples_torch/train_lm.py [--steps 300]
"""
import argparse

from repro_torch import resolve_device
from repro_torch.configs import archs
from repro_torch.configs.base import ModelConfig

# ~103M params: qwen2-style dense decoder (the reference's lm-100m)
LM100M = ModelConfig(
    name="lm-100m", family="dense",
    num_layers=10, d_model=640, num_heads=10, num_kv_heads=2, head_dim=64,
    d_ff=2560, vocab_size=32000, tie_embeddings=True, mlp_gated=True,
)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=300)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--seq", type=int, default=256)
    ap.add_argument("--ckpt-dir", default="ckpt/lm100m")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    resolve_device(args.device)          # no card: raise before anything

    print(f"params: {LM100M.param_count()/1e6:.1f}M")
    archs.ARCHS["lm-100m"] = LM100M      # register for the launcher
    from repro_torch.launch import train as T
    return T.main(["--arch", "lm-100m", "--steps", str(args.steps),
                   "--batch", str(args.batch), "--seq", str(args.seq),
                   "--ckpt-dir", args.ckpt_dir, "--lr", "6e-4",
                   "--save-every", "100", "--device", args.device])


if __name__ == "__main__":
    main()
