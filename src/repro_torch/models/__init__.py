"""LM substrate on PyTorch: the architectures of ``repro.models``
(counterpart of the JAX package's ``models/``).

  common.py      ModelConfig, ParamDef and the init, norms, MLPs
  rope.py        RoPE / M-RoPE position embeddings
  attention.py   GQA attention (global / local window), KV caches
  moe.py         MoE: RaFI expert-parallel dispatch on the port's
                 ``forward_work`` (the paper's technique) and the dense
                 tensor-parallel baseline
  rwkv6.py       RWKV-6 block: chunkwise-parallel scan, O(1)-state decode
  griffin.py     RG-LRU recurrent block (recurrentgemma)
  transformer.py decoder-only assembly (dense / moe / ssm / hybrid)
  encdec.py      encoder-decoder assembly (seamless-m4t backbone)
  api.py         build_model(config) → init / loss / prefill / decode, and
                 params_from_jax (the reference's parameter tree → the port's)
  parallel.py    the placed train step's rank context and differentiable
                 collectives (tensor parallelism over ``model``, FSDP
                 gathers over ``data``)

Parameters are ``nn.Module``s whose names follow the reference's tree paths
(``blocks.k0_moe.attn.wq``); the layer functions are free functions over a
nested dict of tensors, as in the reference.  R logical ranks run
rank-stacked on one device (``launch.mesh.Layout``); the dense and MoE
families' state can be placed on them (``launch.placement``), and their
``*_placed`` layer functions run on each rank's blocks.
"""
