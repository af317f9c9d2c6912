"""Shared model machinery: config, parameters, norms, MLPs (counterpart of
``repro.models.common``).

A model's parameters are declared as a nested dict of :class:`ParamDef`
(shape, init scale, init kind), the reference's declarations without their
``PartitionSpec``: the port runs its logical ranks rank-stacked on one
device, so there is no sharding to declare.  :class:`ParamTree` turns such a
dict into an ``nn.Module`` whose parameter names follow the reference's tree
paths, and ``tree()`` gives the nested dict of tensors that the layer
functions take.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.models import parallel as P

__all__ = [
    "ModelConfig", "ParamDef", "ParamTree", "activation", "cross_entropy_loss", "cross_entropy_loss_placed",
    "cross_entropy_loss_rows", "dense",
    "glu_mlp", "glu_mlp_placed", "init_params", "mlp_defs", "rmsnorm", "tree_map",
]


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    kind: str                     # dense | moe | ssm | hybrid | encdec
    num_layers: int
    d_model: int
    num_heads: int
    num_kv_heads: int
    head_dim: int
    d_ff: int
    vocab_size: int
    qkv_bias: bool = False
    rope_theta: float = 1e4
    rope_kind: str = "full"       # full | mrope
    act: str = "silu"             # silu (SwiGLU) | gelu (GeGLU)
    tie_embeddings: bool = False
    window: int = 0               # local-attention window size
    pattern: Tuple[str, ...] = ("global",)  # repeating per-layer block kinds
    num_experts: int = 0
    top_k: int = 0
    moe_dispatch: str = "rafi_ep"  # rafi_ep (paper technique) | dense_tp
    capacity_factor: float = 1.25
    encoder_layers: int = 0
    frontend: str = "none"        # none | vision | audio (stub embeddings)
    scale_embed: bool = False     # gemma-style sqrt(d_model) embedding scale
    dtype: str = "bfloat16"       # bfloat16 | float32 | float64 (the unsharded path only)
    fsdp: bool = False            # the reference's data-axis parameter sharding
    remat: bool = True            # the reference's per-layer rematerialisation
    scan_unroll: bool = False     # the reference's unrolled layer scan
    blocked_attention: bool = True  # online-softmax KV-blocked attention
                                    # (False = paper-faithful naive baseline)
    microbatches: int = 1         # gradient-accumulation splits of the batch
    dp_over_model: bool = False   # the reference's TP width policy
    source: str = ""

    @property
    def torch_dtype(self) -> torch.dtype:
        return {"bfloat16": torch.bfloat16, "float64": torch.float64}.get(self.dtype, torch.float32)

    @property
    def jdtype(self) -> torch.dtype:
        """The reference's name for the activation dtype (a torch dtype here)."""
        return self.torch_dtype

    def layer_kind(self, i: int) -> str:
        return self.pattern[i % len(self.pattern)]


# --------------------------------------------------------------- parameters

class ParamDef:
    """Declarative parameter: shape + init scale + init kind."""

    def __init__(self, shape, *, scale=None, init="normal"):
        self.shape = tuple(int(s) for s in shape)
        self.scale = scale
        self.init = init

    def fill_(self, t: torch.Tensor, generator: torch.Generator) -> torch.Tensor:
        """Initialise ``t`` (of this shape) in place: zeros, ones, or a
        normal truncated to [-2, 2] times the scale, drawn in float32 and
        cast, as the reference's ``truncated_normal``.  As there, the default
        scale is ``1/sqrt(shape[0])``: for a stacked leaf that is its layer
        axis."""
        if self.init == "zeros":
            return t.zero_()
        if self.init == "ones":
            return t.fill_(1)
        scale = self.scale if self.scale is not None else 1.0 / np.sqrt(self.shape[0])
        # chunks along dim 0 bound the float32 draw at 2^28 elements
        rows = max(1, (1 << 28) // max(1, math.prod(self.shape[1:])))
        for i in range(0, self.shape[0] if self.shape else 1, rows):
            part = t[i:i + rows] if self.shape else t
            draw = torch.empty(part.shape, dtype=torch.float32, device=t.device)
            torch.nn.init.trunc_normal_(draw, 0.0, 1.0, -2.0, 2.0, generator=generator)
            part.copy_(draw.mul_(scale))
        return t


def stack_defs(defs, n: int):
    """The defs of ``n`` stacked copies (a leading layer axis)."""
    return tree_map(lambda p: ParamDef((n,) + p.shape, scale=p.scale, init=p.init), defs)


def tree_map(fn, tree):
    """Map ``fn`` over the leaves of a nested dict."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v) for k, v in tree.items()}
    return fn(tree)


def tree_leaves(tree):
    if isinstance(tree, dict):
        return [leaf for k in tree for leaf in tree_leaves(tree[k])]
    return [tree]


class ParamTree(nn.Module):
    """A nested dict of :class:`ParamDef` as an ``nn.Module``: a dict is a
    submodule, a def a parameter of its shape (uninitialised; see
    :func:`init_params`).  Serving needs no gradient, so the parameters do
    not require one; the trainer turns it on for its own module
    (``launch.steps.build_train_step``)."""

    def __init__(self, defs: Dict[str, Any], *, dtype: torch.dtype, device=None):
        super().__init__()
        self.defs = defs
        for name, d in defs.items():
            if isinstance(d, ParamDef):
                self.register_parameter(
                    name, nn.Parameter(torch.empty(d.shape, dtype=dtype, device=device), requires_grad=False))
            else:
                self.add_module(name, self.child(name, d, dtype=dtype, device=device))

    def child(self, name: str, defs, *, dtype, device) -> nn.Module:
        return ParamTree(defs, dtype=dtype, device=device)

    def tree(self, index: Optional[int] = None) -> Dict[str, Any]:
        """The nested dict of tensors; with ``index``, every leaf's entry
        ``index`` of its leading (stacked layer) axis."""
        out = {}
        for name in self.defs:
            v = getattr(self, name)
            out[name] = v.tree(index) if isinstance(v, ParamTree) else (v if index is None else v[index])
        return out


def init_params(module: ParamTree, generator: torch.Generator) -> ParamTree:
    """Initialise every parameter of ``module`` from its def, in definition
    order, from one generator."""
    def visit(m: ParamTree):
        for name, d in m.defs.items():
            v = getattr(m, name)
            if isinstance(d, ParamDef):
                d.fill_(v.data, generator)
            else:
                visit(v)

    with torch.no_grad():
        visit(module)
    return module


# ------------------------------------------------------------------- layers

def rmsnorm(x, gamma, eps=1e-6):
    wide = torch.promote_types(x.dtype, torch.float32)
    x32 = x.to(wide)
    var = torch.mean(x32 * x32, dim=-1, keepdim=True)
    return ((x32 * torch.rsqrt(var + eps)) * (1.0 + gamma.to(wide))).to(x.dtype)


def dense(x, w, b=None):
    y = x @ w
    if b is not None:
        y = y + b
    return y


def activation(x, act: str):
    # jax.nn.gelu's default is the tanh approximation
    return F.silu(x) if act == "silu" else F.gelu(x, approximate="tanh")


def glu_mlp(x, wi, wg, wo, act: str):
    """Gated MLP (SwiGLU/GeGLU): down( act(gate(x)) * up(x) )."""
    return (activation(x @ wg, act) * (x @ wi)) @ wo


def glu_mlp_placed(x, wi, wg, wo, act: str, ranks):
    """:func:`glu_mlp` on every local rank (``models.parallel``): x ``(L, b,
    s, d)`` whole on each model rank, ``wi``/``wg`` ``(L, d, f/model)``
    column-parallel, ``wo`` ``(L, f/model, d)`` row-parallel, its partial
    products summed over ``model``."""
    x = P.copy_model(x, ranks)
    return P.psum_model(P.mm(activation(P.mm(x, wg), act) * P.mm(x, wi), wo), ranks)


def mlp_defs(cfg: ModelConfig, d_ff: Optional[int] = None) -> Dict[str, ParamDef]:
    f = d_ff or cfg.d_ff
    d = cfg.d_model
    return {
        "wi": ParamDef((d, f)),
        "wg": ParamDef((d, f)),
        "wo": ParamDef((f, d), scale=1.0 / np.sqrt(f)),
    }


def cross_entropy_loss(logits, labels, *, vocab: int):
    """Mean token CE in float32 (logits may be bfloat16)."""
    logits = logits.to(torch.float32)
    logz = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, -1, labels.to(torch.int64)[..., None])[..., 0]
    return torch.mean(logz - gold)


def cross_entropy_loss_rows(logits, labels):
    """Each local rank's mean token CE in float32 over the whole
    vocabulary (its own rows, ``dp_over_model``): logits ``(L, b, s,
    V)``, labels ``(L, b, s)`` → ``(L,)``, as :func:`cross_entropy_loss`
    rank by rank."""
    logits = logits.to(torch.float32)
    gold = torch.gather(logits, -1, labels.to(torch.int64)[..., None])[..., 0]
    return torch.mean(torch.logsumexp(logits, dim=-1) - gold, dim=(1, 2))


def cross_entropy_loss_placed(logits, labels, ranks):
    """Each local rank's mean token CE in float32 over a vocabulary split
    over ``model``: logits ``(L, b, s, V/model)`` (rank (g, m) holds
    columns ``[m·V/model, …)``), labels ``(L, b, s)`` → ``(L,)``.  The
    log-sum-exp from the group's largest logit (a gather of each rank's,
    no gradient) and one ``psum`` over ``model`` of the shifted sum of
    exponentials with the gold logit (picked by the rank that holds it,
    zero elsewhere)."""
    logits = logits.to(torch.float32)
    vm = logits.shape[-1]
    top = logits.detach().amax(dim=-1)
    if ranks.model > 1:
        with torch.no_grad():
            top = ranks.comm.all_gather(top, digits=ranks.digits, tier=P.MODEL_TIER).amax(dim=1)
    ids = labels.to(torch.int64) - (ranks.mrank * vm).view(-1, 1, 1)
    own = (ids >= 0) & (ids < vm)
    gold = torch.gather(logits, -1, ids.clamp(0, vm - 1)[..., None])[..., 0].masked_fill(~own, 0.0)
    sums = P.psum_model(torch.stack([torch.exp(logits - top[..., None]).sum(dim=-1), gold], dim=1), ranks)
    return torch.mean(top + torch.log(sums[:, 0]) - sums[:, 1], dim=(1, 2))
