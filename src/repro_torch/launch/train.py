"""End-to-end training driver: data → train_step → checkpoints
(counterpart of ``repro.launch.train``).

The fault-tolerance contract of the reference:
  * auto-resume: on start, the trainer restores the latest checkpoint and
    continues from its step; the data pipeline is a pure function of step,
    so a killed-and-restarted run reproduces the uninterrupted run;
  * periodic atomic checkpoints (``--ckpt-every``) in the reference's file
    layout, so a run the JAX package checkpointed resumes here;
  * with ``place=True`` (``--place``) the state lives placed on the layout,
    as the reference's ``train()`` places it on its mesh: each rank holds
    its blocks of the parameters and AdamW state, the step runs tensor
    parallel over ``model`` and FSDP over ``data`` (``launch.placement``),
    checkpoints are written whole and a resume places them again.

Runs on the CUDA card; ``device="cpu"`` (``--cpu``) runs the plain PyTorch
path.  Usage (smoke config):
  PYTHONPATH=src python -m repro_torch.launch.train --arch qwen2-7b --smoke \\
      --steps 100 --batch 8 --seq 128 --ckpt-dir ckpt [--cpu]
"""
from __future__ import annotations

import argparse
import dataclasses
import os
import tempfile
import time
from typing import Optional, Union

import torch

from repro_torch import compat
from repro_torch.ckpt import latest_step, restore_checkpoint, save_checkpoint
from repro_torch.configs import get_config, get_smoke_config
from repro_torch.data import SyntheticLM
from repro_torch.launch.mesh import make_test_layout
from repro_torch.launch.placement import train_placement
from repro_torch.launch.steps import build_train_step
from repro_torch.models.api import build_model
from repro_torch.models.common import ModelConfig, tree_map
from repro_torch.optim import AdamWConfig, adamw_init

__all__ = ["main", "train"]


def _default_ckpt_dir() -> str:
    return os.path.join(tempfile.gettempdir(), "repro_torch_ckpt")


def train(
    *,
    arch: Union[str, ModelConfig] = "qwen2-7b",
    smoke: bool = True,
    steps: int = 50,
    batch: int = 8,
    seq: int = 128,
    ckpt_dir: Optional[str] = None,
    ckpt_every: int = 20,
    layout=None,
    log_every: int = 10,
    opt_cfg: AdamWConfig = AdamWConfig(warmup_steps=20),
    verbose: bool = True,
    device=None,
    comm=None,
    place: bool = False,
):
    """Train ``arch`` (a registry name, its smoke config when ``smoke``,
    or a :class:`ModelConfig` as given) on :class:`SyntheticLM` batches.
    Returns ``(params, opt_state, [(step, loss), ...])``; ``layout`` is the
    MoE dispatch's rank layout (default 2 × 4), ``ckpt_dir`` defaults to
    :func:`_default_ckpt_dir`, ``ckpt_every=0`` writes none.  ``comm`` (a
    ``DistributedCollectives``, or the layout's) trains data-parallel over
    its world: every process draws the same global batch and keeps its
    rows (``launch.steps``), the replicas stay equal, process 0 alone
    writes the checkpoints and the others wait for it at a barrier.

    ``place=True`` places the state on ``layout`` (the text-only dense,
    MoE, hybrid and ssm families; module docstring) and returns it placed
    (``launch.placement.Placed`` parameters, an AdamW state with placed
    moments).  The stub-frontend families place too (``launch.
    placement``), but train on no :class:`SyntheticLM` batch: qwen2-vl
    takes ``embeds`` and ``labels``, seamless-m4t-medium ``frames``; drive
    their placed step with ``build_train_step`` on such a batch (the
    encoder-decoder split over ``model`` or under ``dp_over_model``).
    It is not the
    default: the data-parallel step's laws (a world of W processes equals
    W microbatches, one ``grad_all_reduce`` a step) hold for whole
    parameters only."""
    cfg = arch if isinstance(arch, ModelConfig) else (get_smoke_config(arch) if smoke else get_config(arch))
    dev = compat.resolve_device(device)
    ckpt_dir = ckpt_dir or _default_ckpt_dir()
    model = build_model(cfg)
    layout = layout or make_test_layout()
    comm = comm if comm is not None else layout.comm
    ds = SyntheticLM(cfg.vocab_size, seq, batch)
    step_fn = build_train_step(model, layout, opt_cfg, comm=comm)
    placement = train_placement(model, dataclasses.replace(layout, comm=comm)) if place else None

    def save(step):
        if placement is not None:  # every process gathers, one writes
            state = {"params": placement.gather(params), "opt": placement.gather(opt)}
        else:
            state = {"params": params.tree(), "opt": opt}
        if comm is None or comm.index == 0:
            save_checkpoint(ckpt_dir, step, state)
        if comm is not None:
            comm.barrier()

    params = model.init(torch.Generator(device=dev).manual_seed(0), device=dev)
    start = latest_step(ckpt_dir)
    start_step = 0
    if start is None:
        if placement is not None:
            params = placement.place(params)
        opt = adamw_init(params, opt_cfg)
    else:
        if verbose and (comm is None or comm.index == 0):
            print(f"[train] resuming from checkpoint step {start}")
        # the state's shapes from meta tensors: restore allocates it once
        meta = tree_map(lambda p: torch.empty(p.shape, dtype=p.dtype, device="meta"), params.tree())
        like = {"params": params.tree(), "opt": adamw_init(meta, opt_cfg)}
        shardings = None if placement is None else {"params": placement, "opt": placement}
        state = restore_checkpoint(ckpt_dir, start, like, device=dev, shardings=shardings)
        if placement is not None:
            params = state["params"]
        else:
            with torch.no_grad():
                _copy_tree(params.tree(), state["params"])
        opt = state["opt"]
        del state
        start_step = start

    losses = []
    t0 = time.time()
    for step in range(start_step, steps):
        params, opt, metrics = step_fn(params, opt, ds.batch_at(step))
        loss = float(metrics["loss"])
        losses.append((step, loss))
        if verbose and (comm is None or comm.index == 0) and (step % log_every == 0 or step == steps - 1):
            print(f"[train] step {step:5d} loss {loss:8.4f} ({time.time() - t0:.1f}s)", flush=True)
        if ckpt_every and (step + 1) % ckpt_every == 0:
            save(step + 1)
    if ckpt_every:
        save(steps)
    return params, opt, losses


def _copy_tree(dst, src):
    for k, v in dst.items():
        if isinstance(v, dict):
            _copy_tree(v, src[k])
        else:
            v.copy_(src[k])


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen2-7b")
    ap.add_argument("--smoke", action="store_true", default=True)
    ap.add_argument("--full", dest="smoke", action="store_false")
    ap.add_argument("--steps", type=int, default=50)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--ckpt-dir", default=None, help=f"default: {_default_ckpt_dir()}")
    ap.add_argument("--ckpt-every", type=int, default=20)
    ap.add_argument("--cpu", action="store_true", help="run on the CPU (plain PyTorch versions of the kernels)")
    ap.add_argument("--place", action="store_true",
                    help="place the state on the (2, 4) layout (the text-only dense, MoE, hybrid and ssm families; "
                         "the stub-frontend families take no token batch: build_train_step)")
    args = ap.parse_args(argv)
    train(
        arch=args.arch, smoke=args.smoke, steps=args.steps, batch=args.batch,
        seq=args.seq, ckpt_dir=args.ckpt_dir, ckpt_every=args.ckpt_every,
        device="cpu" if args.cpu else None, place=args.place,
    )


if __name__ == "__main__":
    main()
