"""Contrastive fine-tuning of the recompute encoder on one device.

Counterpart of the JAX package's ``parallel/train.py``: the encoder is
fine-tuned on (query, passage) pairs with a symmetric InfoNCE objective over
in-batch negatives, through the same :func:`encode_tokens` the index build
and search run. The JAX package shards the step over a ``(dp, tp)`` mesh;
here it runs on one device, with no mesh and no parameter layout.

The fine-tuning path: start from a checkpoint directory
(``load_hf_weights``), train, write the tree back with ``save_hf_weights``
and build an index from that directory (``LeannBuilder(embedding_model=
<dir>)``), which recomputes the corpus calibration.
"""

from __future__ import annotations

from typing import Dict, List, Optional

import numpy as np
import torch
import torch.nn.functional as F

from ..device import matmul, resolve_device
from ..embeddings.encoder import EncoderConfig, encode_tokens, init_params

# the trained leaves: calibration (out_center / out_pc) is a statistic of the
# corpus an index serves, recomputed at build, so a loaded tree's is dropped
TRAINED_KEYS = ("tok_emb", "pos_emb", "emb_ln", "final_ln", "layers")


def info_nce_loss(params: Dict, q_ids: torch.Tensor, q_mask: torch.Tensor, d_ids: torch.Tensor,
                  d_mask: torch.Tensor, cfg: EncoderConfig, temperature: float = 0.05) -> torch.Tensor:
    """Symmetric InfoNCE over in-batch negatives: the [B, B] logits
    ``qe @ de.T / temperature`` in f32, cross-entropy against the diagonal
    both ways, the mean of the two -> a scalar tensor."""
    qe = encode_tokens(params, q_ids, q_mask, cfg)  # [B, D]
    de = encode_tokens(params, d_ids, d_mask, cfg)
    logits = matmul(qe, de.T) / temperature
    labels = torch.arange(logits.shape[0], device=logits.device)
    return 0.5 * (F.cross_entropy(logits, labels) + F.cross_entropy(logits.T, labels))


def _leaves(tree) -> List[torch.Tensor]:
    if isinstance(tree, dict):
        return [t for v in tree.values() for t in _leaves(v)]
    if isinstance(tree, (list, tuple)):
        return [t for v in tree for t in _leaves(v)]
    return [tree]


def _trainable(tree, dev: torch.device):
    """A tree of numpy arrays or tensors -> the same tree of f32 leaves on
    ``dev`` that own their storage and require gradients."""
    if isinstance(tree, dict):
        return {k: _trainable(v, dev) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_trainable(v, dev) for v in tree]
    if isinstance(tree, torch.Tensor):
        leaf = tree.detach().to(dev, torch.float32, copy=True)
    else:
        leaf = torch.from_numpy(np.array(tree, np.float32)).to(dev)
    return leaf.requires_grad_()


class ContrastiveTrainer:
    """The encoder's params, an AdamW optimizer over every leaf and the
    training step, on one device.

    ``params=None`` starts from the seeded ``init_params(cfg)`` (the JAX
    package's draws); ``params=`` takes a tree such as ``load_hf_weights``
    gives, of which only :data:`TRAINED_KEYS` are kept. The optimizer is
    ``torch.optim.AdamW`` with betas (0.9, 0.999), eps 1e-8 and the decay on
    every leaf, the update optax's ``adamw`` makes. ``params`` stays the
    encoder's tree of f32 tensors, so ``save_hf_weights(trainer.params, cfg,
    path)`` writes a checkpoint an index can be built from. ``device``
    defaults to cuda and raises without it. ``mesh`` stands second, as in
    the JAX package's signature; only ``None`` (one device) is ported."""

    def __init__(self, cfg: EncoderConfig, mesh=None, learning_rate: float = 2e-5, weight_decay: float = 0.01,
                 temperature: float = 0.05, params: Optional[Dict] = None, device: "str | torch.device" = "cuda"):
        if mesh is not None:
            from ..backends.common import not_ported

            raise not_ported("the trainer's (dp, tp) mesh", "ROADMAP.md §A #5")
        self.device = resolve_device(device)
        self.cfg = cfg
        self.temperature = temperature
        tree = init_params(cfg) if params is None else {k: params[k] for k in TRAINED_KEYS}
        self.params = _trainable(tree, self.device)
        self._leaves = _leaves(self.params)
        self.optimizer = torch.optim.AdamW(self._leaves, lr=learning_rate, betas=(0.9, 0.999), eps=1e-8,
                                           weight_decay=weight_decay)

    def train_step(self, q_ids, q_mask, d_ids, d_mask) -> float:
        """One step on a batch of pairs (token ids and masks [B, T], numpy or
        tensors; queries and passages may differ in T) -> the loss before
        the update, as a Python float."""
        dev = self.device
        batch = [torch.as_tensor(x).to(dev) for x in (q_ids, q_mask, d_ids, d_mask)]
        with torch.enable_grad():
            loss = info_nce_loss(self.params, *batch, self.cfg, self.temperature)
            self.optimizer.zero_grad(set_to_none=False)
            loss.backward()
        # a leaf the forward does not read (emb_ln of prenorm, final_ln of
        # bert) has a zero gradient, not none: optax decays it all the same
        for leaf in self._leaves:
            if leaf.grad is None:
                leaf.grad = torch.zeros_like(leaf)
        self.optimizer.step()
        return float(loss.detach())
