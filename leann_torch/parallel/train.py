"""Contrastive fine-tuning of the recompute encoder, on one device or a
``(dp, tp)`` mesh.

Counterpart of the JAX package's ``parallel/train.py``: the encoder is
fine-tuned on (query, passage) pairs with a symmetric InfoNCE objective over
in-batch negatives, through the same :func:`encode_tokens` the index build
and search run.

On a mesh (``ContrastiveTrainer(cfg, mesh)``, ``mesh.make_mesh([("dp", ..),
("tp", ..)])``) the layout is the JAX package's :func:`param_specs`: the
q / k / v and fc1 weights are split by columns over ``tp`` (each shard holds
whole attention heads and a slice of the MLP), o and fc2 by rows, the rest
replicated. Each ``tp`` shard computes its heads' attention and its MLP
slice and the shards' partial projections are summed (``encode_tokens``'s
``tp=``, Megatron's layout); the batch is split over ``dp``, and the pooled
embeddings of every ``dp`` group are gathered for the [B, B] logits.
Autograd runs back through the sums and the copies, so a replicated leaf
gets the sum of its uses' gradients, which is the all-reduce the JAX
package's compiler inserts. A split leaf is held as its ``tp`` parts, each
on its shard's device, and AdamW acts on each part: the update is
elementwise, so the parts get the update the whole leaf would.

The fine-tuning path: start from a checkpoint directory
(``load_hf_weights``), train, write the tree back with ``save_hf_weights``
and build an index from that directory (``LeannBuilder(embedding_model=
<dir>)``), which recomputes the corpus calibration.
"""

from __future__ import annotations

from typing import Dict, List, NamedTuple, Optional

import numpy as np
import torch
import torch.nn.functional as F

from ..device import matmul, resolve_device
from ..embeddings.encoder import EncoderConfig, encode_tokens, init_params
from .mesh import Mesh

# the trained leaves: calibration (out_center / out_pc) is a statistic of the
# corpus an index serves, recomputed at build, so a loaded tree's is dropped
TRAINED_KEYS = ("tok_emb", "pos_emb", "emb_ln", "final_ln", "layers")


def param_specs(cfg: EncoderConfig) -> Dict:
    """The layout of the encoder's tree over mesh axes (dp, tp), as the JAX
    package's PartitionSpecs: a tuple per leaf naming the axis each dim is
    split over (None: not split; (): replicated). q / k / v project D ->
    D split over tp; o projects that back to D; fc1 D -> F split over tp;
    fc2 back to D. Embeddings and LayerNorms replicate."""
    ln = {"scale": (), "bias": ()}
    layer = {
        "ln1": ln, "ln2": ln,
        "q": {"w": (None, "tp"), "b": ("tp",)},
        "k": {"w": (None, "tp"), "b": ("tp",)},
        "v": {"w": (None, "tp"), "b": ("tp",)},
        "o": {"w": ("tp", None), "b": ()},
        "fc1": {"w": (None, "tp"), "b": ("tp",)},
        "fc2": {"w": ("tp", None), "b": ()},
    }
    return {"tok_emb": (), "pos_emb": (), "emb_ln": ln, "final_ln": ln, "layers": [layer for _ in range(cfg.n_layers)]}


def _info_nce(qe: torch.Tensor, de: torch.Tensor, temperature: float) -> torch.Tensor:
    logits = matmul(qe, de.T) / temperature
    labels = torch.arange(logits.shape[0], device=logits.device)
    return 0.5 * (F.cross_entropy(logits, labels) + F.cross_entropy(logits.T, labels))


def info_nce_loss(params: Dict, q_ids: torch.Tensor, q_mask: torch.Tensor, d_ids: torch.Tensor,
                  d_mask: torch.Tensor, cfg: EncoderConfig, temperature: float = 0.05) -> torch.Tensor:
    """Symmetric InfoNCE over in-batch negatives: the [B, B] logits
    ``qe @ de.T / temperature`` in f32, cross-entropy against the diagonal
    both ways, the mean of the two -> a scalar tensor."""
    return _info_nce(encode_tokens(params, q_ids, q_mask, cfg), encode_tokens(params, d_ids, d_mask, cfg),
                     temperature)


class Split(NamedTuple):
    """A leaf split over ``tp``: its parts along ``dim``, part j on the
    device of tp shard j."""

    parts: List[torch.Tensor]
    dim: int


def _leaves(tree) -> List[torch.Tensor]:
    if isinstance(tree, Split):
        return list(tree.parts)
    if isinstance(tree, dict):
        return [t for v in tree.values() for t in _leaves(v)]
    if isinstance(tree, (list, tuple)):
        return [t for v in tree for t in _leaves(v)]
    return [tree]


def _f32(leaf, dev: torch.device) -> torch.Tensor:
    """A numpy array or tensor -> an f32 copy on ``dev`` that owns its
    storage."""
    if isinstance(leaf, torch.Tensor):
        return leaf.detach().to(dev, torch.float32, copy=True)
    return torch.from_numpy(np.array(leaf, np.float32)).to(dev)


def _trainable(tree, dev: torch.device):
    """A tree of numpy arrays or tensors -> the same tree of f32 leaves on
    ``dev`` that own their storage and require gradients."""
    if isinstance(tree, dict):
        return {k: _trainable(v, dev) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_trainable(v, dev) for v in tree]
    return _f32(tree, dev).requires_grad_()


def _laid_out(tree, spec, tp_devs: List[torch.device]):
    """The tree laid out by ``spec`` (:func:`param_specs`): a leaf split
    over tp becomes a :class:`Split` of trainable parts on ``tp_devs``, a
    replicated one a trainable leaf on ``tp_devs[0]``."""
    if isinstance(tree, dict):
        return {k: _laid_out(v, spec[k], tp_devs) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_laid_out(v, s, tp_devs) for v, s in zip(tree, spec)]
    if "tp" not in spec:
        return _f32(tree, tp_devs[0]).requires_grad_()
    whole = _f32(tree, torch.device("cpu"))
    dim = spec.index("tp")
    parts = whole.chunk(len(tp_devs), dim)
    return Split([p.clone(memory_format=torch.contiguous_format).to(dev).requires_grad_()
                  for p, dev in zip(parts, tp_devs)], dim)


def _shard_view(tree, j: int, dev: torch.device):
    """tp shard j's params on ``dev``: its part of each split leaf and the
    replicated leaves (copies through which autograd runs back, where
    ``dev`` is not their device)."""
    if isinstance(tree, Split):
        return tree.parts[j].to(dev)
    if isinstance(tree, dict):
        return {k: _shard_view(v, j, dev) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_shard_view(v, j, dev) for v in tree]
    return tree.to(dev)


def _whole(tree):
    """The tree with each split leaf joined again (detached copies)."""
    if isinstance(tree, Split):
        return torch.cat([p.detach().to(tree.parts[0].device) for p in tree.parts], dim=tree.dim)
    if isinstance(tree, dict):
        return {k: _whole(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_whole(v) for v in tree]
    return tree


class ContrastiveTrainer:
    """The encoder's params, an AdamW optimizer over every leaf and the
    training step, on one device or over a ``(dp, tp)`` mesh.

    ``params=None`` starts from the seeded ``init_params(cfg)`` (the JAX
    package's draws); ``params=`` takes a tree such as ``load_hf_weights``
    gives, of which only :data:`TRAINED_KEYS` are kept. The optimizer is
    ``torch.optim.AdamW`` with betas (0.9, 0.999), eps 1e-8 and the decay on
    every leaf, the update optax's ``adamw`` makes. :attr:`params` is the
    encoder's whole tree of f32 tensors, so ``save_hf_weights(trainer.params,
    cfg, path)`` writes a checkpoint an index can be built from.

    ``mesh``: None trains on ``device`` (default cuda, raising without it);
    a :class:`~.mesh.Mesh` with axes ``dp`` and / or ``tp`` trains over its
    devices (``device`` is then unused) with the layout of
    :func:`param_specs`. ``tp`` must divide the heads and the MLP width,
    and ``dp`` each batch."""

    def __init__(self, cfg: EncoderConfig, mesh: Optional[Mesh] = None, learning_rate: float = 2e-5,
                 weight_decay: float = 0.01, temperature: float = 0.05, params: Optional[Dict] = None,
                 device: "str | torch.device" = "cuda"):
        self.cfg = cfg
        self.mesh = mesh
        self.temperature = temperature
        tree = init_params(cfg) if params is None else {k: params[k] for k in TRAINED_KEYS}
        if mesh is None:
            self.device = resolve_device(device)
            self._tree = _trainable(tree, self.device)
        else:
            self.dp, self.tp = int(mesh.shape.get("dp", 1)), int(mesh.shape.get("tp", 1))
            if set(mesh.axis_names) - {"dp", "tp"}:
                raise ValueError(f"the trainer's mesh takes axes dp and tp, not {mesh.axis_names}")
            if cfg.n_heads % self.tp or cfg.mlp_dim % self.tp:
                raise ValueError(f"tp={self.tp} must divide the heads ({cfg.n_heads}) and the MLP width "
                                 f"({cfg.mlp_dim})")
            order = [mesh.axis_names.index(a) for a in ("dp", "tp") if a in mesh.shape]
            self.grid = mesh.devices.transpose(order).reshape(self.dp, self.tp)
            self.device = self.grid[0, 0]
            self._tree = _laid_out(tree, param_specs(cfg), list(self.grid[0]))
        self._leaves = _leaves(self._tree)
        self.optimizer = torch.optim.AdamW(self._leaves, lr=learning_rate, betas=(0.9, 0.999), eps=1e-8,
                                           weight_decay=weight_decay)

    @property
    def params(self) -> Dict:
        """The encoder's tree: on one device the trained tensors
        themselves, on a mesh the split leaves joined (detached copies on
        the first tp shard's device)."""
        return self._tree if self.mesh is None else _whole(self._tree)

    def _loss(self, q_ids, q_mask, d_ids, d_mask) -> torch.Tensor:
        if self.mesh is None:
            dev = self.device
            return info_nce_loss(self._tree, q_ids.to(dev), q_mask.to(dev), d_ids.to(dev), d_mask.to(dev),
                                 self.cfg, self.temperature)
        b = q_ids.shape[0]
        if b % self.dp:
            raise ValueError(f"a batch of {b} does not split over dp={self.dp}")
        per = b // self.dp
        qe, de = [], []
        for i, devs in enumerate(self.grid):
            devs = list(devs)
            shards = [_shard_view(self._tree, j, dev) for j, dev in enumerate(devs)]
            rows = slice(i * per, (i + 1) * per)
            for out, ids, mask in ((qe, q_ids, q_mask), (de, d_ids, d_mask)):
                e = encode_tokens(shards[0], ids[rows].to(devs[0]), mask[rows].to(devs[0]), self.cfg,
                                  tp=list(zip(shards, devs)))
                out.append(e.to(self.device))
        return _info_nce(torch.cat(qe), torch.cat(de), self.temperature)

    def train_step(self, q_ids, q_mask, d_ids, d_mask) -> float:
        """One step on a batch of pairs (token ids and masks [B, T], numpy or
        tensors; queries and passages may differ in T) -> the loss before
        the update, as a Python float."""
        batch = [torch.as_tensor(x) for x in (q_ids, q_mask, d_ids, d_mask)]
        with torch.enable_grad():
            loss = self._loss(*batch)
            self.optimizer.zero_grad(set_to_none=False)
            loss.backward()
        # a leaf the forward does not read (emb_ln of prenorm, final_ln of
        # bert) has a zero gradient, not none: optax decays it all the same
        for leaf in self._leaves:
            if leaf.grad is None:
                leaf.grad = torch.zeros_like(leaf)
        self.optimizer.step()
        return float(loss.detach())
