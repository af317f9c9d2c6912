"""End-to-end LM training on the PyTorch port (the twin of
``examples/train_lm.py``): the same ~100M-parameter model on synthetic
batches, with periodic atomic checkpoints and auto-resume.

Runs on the CUDA card; ``--cpu`` runs the plain PyTorch path.  Under
``torchrun`` the world trains data-parallel: every process draws the same
batch, keeps its rows and averages the gradient with the others, process 0
writes the checkpoints and prints the same lines.
Run:  PYTHONPATH=src python examples/train_lm_torch.py [--steps 200] [--cpu]
      PYTHONPATH=src python -m torch.distributed.run --standalone --nproc_per_node 2 \
          examples/train_lm_torch.py --cpu
"""
import argparse
import os
import tempfile

from repro_torch.launch import dist
from repro_torch.launch.mesh import make_test_layout
from repro_torch.launch.train import train
from repro_torch.models.api import build_model
from repro_torch.models.common import ModelConfig
from repro_torch.optim import AdamWConfig

# ~100M params: 12L × d=640 × ff=2560, 32k vocab (≈ 63M body + 41M embeddings)
CONFIG_100M = ModelConfig(
    name="repro-100m", kind="dense",
    num_layers=12, d_model=640, num_heads=10, num_kv_heads=5, head_dim=64,
    d_ff=2560, vocab_size=32000, rope_theta=1e4,
    pattern=("global",), dtype="float32", remat=False,
)


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=256)
    ap.add_argument("--ckpt-dir", default=os.path.join(tempfile.gettempdir(), "repro_torch_100m_ckpt"))
    ap.add_argument("--ckpt-every", type=int, default=50, help="0: no checkpoint")
    ap.add_argument("--cpu", action="store_true", help="run on the CPU (plain PyTorch versions of the kernels)")
    args = ap.parse_args()
    device = "cpu" if args.cpu else None
    comm = dist.init_world(device) if "WORLD_SIZE" in os.environ else None
    if comm is not None and device is None:
        device = f"cuda:{os.environ.get('LOCAL_RANK', 0)}"
    lead = comm is None or comm.index == 0

    n = build_model(CONFIG_100M).param_count()
    if lead:
        print(f"training {CONFIG_100M.name}: {n/1e6:.1f}M params")
    _, _, losses = train(
        arch=CONFIG_100M,
        steps=args.steps, batch=args.batch, seq=args.seq,
        ckpt_dir=args.ckpt_dir, ckpt_every=args.ckpt_every,
        layout=make_test_layout(),
        opt_cfg=AdamWConfig(lr=3e-3, warmup_steps=30),
        device=device, comm=comm,
    )
    if losses and lead:
        print(f"steps {losses[0][0]}-{losses[-1][0]}: loss {losses[0][1]:.4f} -> {losses[-1][1]:.4f}")
    dist.destroy_world()


if __name__ == "__main__":
    main()
