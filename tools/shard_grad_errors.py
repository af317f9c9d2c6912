#!/usr/bin/env python3
"""How far float32 gradients of qwen2-7b at full width lie from float64's,
whole and placed, at the config's own random init, on one NVIDIA card.

    python3 tools/shard_grad_errors.py

qwen2-7b at full width, 2 of 28 layers, float32, ``fsdp=True``, remat,
batch 8 x 512 (``SyntheticLM`` step 0), weights from one seeded draw
(``Model.init``, block weights at 1/sqrt(layers)): the gradient of one
loss and backward pass, unsharded in float64 (attention scores and the
loss in float32, as the port computes them), unsharded in float32, and
placed in float32 on layouts (2, 4), (1, 4) and (2, 1) (stacked).  Prints
each run's loss, its gradient norm and the six leaves farthest from the
float64 gradient (relative L2, relative max), and the k bias's relative
error by layer and model-rank column block.  At this init the attention
is saturated and the gradient ill-conditioned, so phase ``shard`` of
``chip_smoke.py`` holds the placed step on conditioned weights.  Writes
``chiprun_out/shard_grad_errors.json``.
"""
import dataclasses as dc, json, sys
sys.path[:0] = ["src", "."]
import torch
import chip_smoke as cs
from repro_torch.configs import get_config
from repro_torch.data import SyntheticLM
from repro_torch.launch import placement as PL
from repro_torch.launch.mesh import Layout
from repro_torch.models.api import build_model
from repro_torch.models.common import tree_leaves

dev = torch.device("cuda", 0)
print(cs.nvidia_smi(), flush=True)
res = {}
for remat in (True,):
    cfg = dc.replace(get_config("qwen2-7b"), num_layers=2, fsdp=True, dtype="float32", remat=remat)
    batch = {k: torch.from_numpy(v).to(dev) for k, v in SyntheticLM(cfg.vocab_size, 512, 8).batch_at(0).items()}
    grads = {}
    for name in ("whole64", "whole32", "placed32", "placed32_1x4", "placed32_2x1"):
        c = cs._float64_config(cfg) if name == "whole64" else cfg
        model = build_model(c)
        lm = model.init(torch.Generator(device=dev).manual_seed(3131), device=dev)
        loss_fn = model.loss_fn(None)
        if name.startswith("placed"):
            layout = {"placed32": Layout(2, 4), "placed32_1x4": Layout(1, 4), "placed32_2x1": Layout(2, 1)}[name]
            pl = PL.train_placement(model, layout)
            p = pl.place(lm); del lm
            for t in tree_leaves(p): t.requires_grad_(True)
            lv = loss_fn(p, batch); lv.sum().backward()
            r = pl.ranks(dev)
            with torch.no_grad():
                g = pl.gather(PL.Placed(pl.reduce(p, r, float(r.data)), pl))
            loss = float(lv.detach().mean())
            del p, lv, pl
        else:
            tree = lm.tree()
            for t in tree_leaves(tree): t.requires_grad_(True)
            l = loss_fn(tree, batch); l.backward()
            g = {k: t.grad for k, t in cs._leaf_items(tree).items()}
            g = cs._nest(g); loss = float(l.detach())
            del lm, tree, l
        grads[name] = {k: v.detach().double().cpu() for k, v in cs._leaf_items(g).items()}
        print(remat, name, "loss", loss, flush=True)
        del g; torch.cuda.empty_cache()
    ref = grads["whole64"]
    out = {}
    for name in ("whole32", "placed32", "placed32_1x4", "placed32_2x1"):
        rows = {}
        for k, v in grads[name].items():
            d = v - ref[k]
            rows[".".join(k)] = [float(d.norm() / ref[k].norm()), float(d.abs().max() / ref[k].abs().max())]
        out[name] = rows
        tot = sum(float(v.norm()) ** 2 for v in grads[name].values()) ** .5
        print(remat, name, "gnorm", tot, "worst", sorted(rows.items(), key=lambda t: -t[1][0])[:6], flush=True)
    # the k bias gradient by model-rank block and by layer
    k = ("blocks", "k0_global", "attn", "bk")
    for name in ("whole32", "placed32", "placed32_1x4", "placed32_2x1"):
        d = grads[name][k] - ref[k]
        print(remat, name, "bk rel err by layer x rank block",
              [[round(float(d[l, m*128:(m+1)*128].norm() / ref[k][l, m*128:(m+1)*128].norm()), 5) for m in range(4)] for l in range(2)], flush=True)
    res[str(remat)] = out
    del grads
import pathlib; pathlib.Path("chiprun_out").mkdir(exist_ok=True)
pathlib.Path("chiprun_out/shard_grad_errors.json").write_text(json.dumps(res, indent=1))
