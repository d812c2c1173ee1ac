"""Tensor parallelism (Megatron-style) of the ViT and InternVideo2 blocks.

Port of simple_tad_tpu/parallel/tp.py.  The JAX module only annotates
parameters with PartitionSpecs over a ('data', 'model') mesh and lets GSPMD
insert the collectives.  PyTorch has no GSPMD and the port's kernels are
bound through kernels/build.py, not as dispatcher ops that DTensor could
shard, so here the job is done the explicit way: each rank of a model
group holds its share of the block weights, and the model's modules
(models/layers.py, models/internvideo2.py) place the collectives by hand
over plain process groups, as two autograd Functions:

  f (``copy_to_model``): identity forward, all-reduce of the gradient
    backward, before the column-parallel qkv and fc1;
  g (``reduce_from_model``): all-reduce forward, identity backward, after
    the row-parallel proj and fc2, whose bias is added once, after it.

LayerNorm / RMSNorm, LayerScale, DropPath, the embeddings, the pooling
head, fc_norm and the classifier stay replicated: every model rank
computes them on the same activations and gets the same whole gradient.

The grid is ``make_2d_mesh``'s: rank r of a world of n has data rank
r // mp and model rank r % mp (the JAX devices.reshape(n // mp, mp)); its
data group (parallel/mesh.py:DataParallel) averages the gradients and
shards the ZeRO state, its model group runs f and g.

Layout, where it differs from the JAX spec: the JAX spec cuts the packed
(C, 3C) qkv kernel along 3C in contiguous blocks, whose boundaries do not
fall on heads (tests/test_tp.py), and GSPMD reshards inside the attention.
Here qkv is cut by head: a rank holds its heads' rows of q, of k and of v
(and of q_bias, v_bias and IV2's q/k-norm weights), so its local qkv is
the packed [q | k | v] of its heads that the attention kernels read, and
the attention needs no collective.  The proj weight is cut along its input
by the same heads.  fc1 (output) and fc2 (input) are cut in contiguous
blocks, as the JAX spec cuts them.

Head padding: a head count the model group does not divide (IV2-6B's 25
over 2 or 4 ranks) is padded at the end to the next multiple (26, 28),
rather than refused.  A padded head has zero qkv rows, bias and q/k-norm
weight and zero proj columns: its q = k = v = 0, so its output is 0 and,
through zero proj columns, it adds exactly 0; its gradients are exactly 0,
so an elementwise optimizer with weight decay keeps it at 0.  Real heads
keep their global indices (the attention dropout's Philox counter,
ops/attention.py).  ``merge_state_dicts`` / ``gather_state_dict`` strip
the padding.  A split that would pad more heads than the model has
raises.

InternVideo2's q/k-norms are RMSNorms over the whole width C: under head
sharding a rank holds only its heads' columns, so ``qk_rmsnorm`` all-reduces
each row's sum of squares (over the true C, not the padded width) forward,
and the row's dot product of the gradient with the output backward.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, NamedTuple, Optional, Sequence, Tuple

import torch
import torch.distributed as dist

from simple_tad_tpu_torch.parallel.mesh import DataParallel


@dataclasses.dataclass(frozen=True)
class ModelParallel:
    """This rank's place in its model group: ``size`` ranks share each
    block's weights, this one is ``rank``; ``group`` is the process group
    (None with size 1: the collectives leave tensors as they are)."""
    size: int
    rank: int
    group: Optional[object] = None

    def all_reduce(self, t: torch.Tensor) -> torch.Tensor:
        """Sum ``t`` over the model group, in place -> t."""
        if self.size > 1:
            dist.all_reduce(t, group=self.group)
        return t

    def all_gather(self, t: torch.Tensor) -> List[torch.Tensor]:
        """Every model rank's ``t`` (of one shape), in rank order.  Over
        gloo a CUDA tensor goes through the host."""
        if self.size == 1:
            return [t]
        if t.is_cuda and dist.get_backend(self.group) == "gloo":
            t = t.cpu()
        t = t.contiguous()
        out = [torch.empty_like(t) for _ in range(self.size)]
        dist.all_gather(out, t, group=self.group)
        return out


def make_2d_mesh(model_parallel: int, device="cuda"
                 ) -> Tuple[DataParallel, ModelParallel]:
    """The (data x model) grid of the default process group ->
    (DataParallel over this rank's data group, ModelParallel over its model
    group).  Every rank builds every group, in the same order (the data
    groups, then the model groups).  The device is the current card for
    'cuda' (multihost.initialize set it to cuda:LOCAL_RANK), else
    ``device`` as given ('cpu' for a gloo run on the host)."""
    world, rank = dist.get_world_size(), dist.get_rank()
    mp = int(model_parallel)
    if mp < 1 or world % mp:
        raise ValueError(f"model_parallel {mp} does not divide the world of "
                         f"{world}")
    n_data = world // mp
    data_groups = [dist.new_group([d * mp + m for d in range(n_data)])
                   for m in range(mp)]
    model_groups = [dist.new_group([d * mp + m for m in range(mp)])
                    for d in range(n_data)]
    data_rank, model_rank = divmod(rank, mp)
    dev = torch.device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    return (DataParallel(n_data, data_rank, dev, data_groups[model_rank]),
            ModelParallel(mp, model_rank, model_groups[data_rank]))


# ------------------------------------------------------------ the operators --

class _CopyToModel(torch.autograd.Function):
    """f: identity forward, the gradient summed over the model group."""

    @staticmethod
    def forward(ctx, x, tp):
        ctx.tp = tp
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        total = ctx.tp.all_reduce(g.to(torch.float32, copy=True))
        return total.to(g.dtype), None


class _ReduceFromModel(torch.autograd.Function):
    """g: the partial sums added over the model group, identity backward."""

    @staticmethod
    def forward(ctx, x, tp):
        return tp.all_reduce(x.clone(memory_format=torch.contiguous_format))

    @staticmethod
    def backward(ctx, g):
        return g, None


def copy_to_model(x: torch.Tensor, tp: Optional[ModelParallel]
                  ) -> torch.Tensor:
    """Megatron's f, before a column-parallel GEMM (``x`` itself without
    ``tp``)."""
    return x if tp is None else _CopyToModel.apply(x, tp)


def reduce_from_model(x: torch.Tensor, tp: ModelParallel) -> torch.Tensor:
    """Megatron's g, after a row-parallel GEMM."""
    return _ReduceFromModel.apply(x, tp)


def row_parallel_linear(x, linear, tp: Optional[ModelParallel],
                        dtype) -> torch.Tensor:
    """``linear`` (a models/layers.py:Linear) with its input cut over the
    model group: this rank's partial product, summed over the group in
    fp32, then the bias once, then rounded to ``dtype``.  Without ``tp``
    the Linear itself, rounded to ``dtype``: the whole model's bits."""
    if tp is None:
        return linear(x).to(dtype)
    y = reduce_from_model(linear(x, bias=False).float(), tp)
    if linear.bias is not None:
        y = y + linear.bias.float()
    return y.to(dtype)


def qk_rmsnorm_plain(x, weight, eps: float, dtype, width: int):
    """The q/k RMSNorm over ``width`` columns of which ``x`` holds some
    (the rest count as 0): fp32 statistics, weight times the normalised
    value, cast to ``dtype``.  At ``width`` = x's own width it is
    models/internvideo2.py:rmsnorm_plain."""
    x32 = x.float()
    var = (x32 * x32).sum(dim=-1, keepdim=True) / width
    return (weight.float() * (x32 * torch.rsqrt(var + eps))).to(dtype)


class QKRMSNorm(torch.autograd.Function):
    """The q/k RMSNorm on a rank's columns of a row of ``width``: the
    row's sum of squares is summed over the model group; backward, with
    r = rsqrt(S / width + eps) and y = w x r,
      dx = r w dy - x r^3 / width * sum_all(w dy x),   dw = sum_rows(dy x r),
    the row sum taken over the model group too."""

    @staticmethod
    def forward(ctx, x, weight, eps: float, dtype, width: int, tp):
        x32 = x.float()
        sq = tp.all_reduce((x32 * x32).sum(dim=-1, keepdim=True))
        r = torch.rsqrt(sq / width + eps)
        ctx.save_for_backward(x, weight, r)
        ctx.width, ctx.tp = width, tp
        return (weight.float() * (x32 * r)).to(dtype)

    @staticmethod
    def backward(ctx, dy):
        x, weight, r = ctx.saved_tensors
        x32, dy32, w = x.float(), dy.float(), weight.float()
        wdy = w * dy32
        dot = ctx.tp.all_reduce((wdy * x32).sum(dim=-1, keepdim=True))
        dx = r * wdy - x32 * (r ** 3) * (dot / ctx.width)
        dw = (dy32 * x32 * r).reshape(-1, x.shape[-1]).sum(0)
        return (dx.to(x.dtype), dw.to(weight.dtype), None, None, None, None)


def qk_rmsnorm(x, weight, eps: float, dtype, width: int,
               tp: ModelParallel) -> torch.Tensor:
    """InternVideo2's q/k-norm on this rank's columns (``QKRMSNorm``; on the
    CPU and the card alike, as the JAX package leaves the RMSNorm to
    XLA)."""
    return QKRMSNorm.apply(x, weight, eps, dtype, width, tp)


# ------------------------------------------------------------------ layout --

class ParamSpec(NamedTuple):
    """How a parameter is laid out over the model group: ``split``
    'replicated', 'column' (the output axis is cut) or 'row' (the input
    axis); ``dim`` the tensor axis cut; ``by_head`` cut at head boundaries
    (padded to the group), else in equal contiguous blocks; ``groups`` the
    blocks along ``dim`` cut alike (3 for the packed q, k, v)."""
    split: str
    dim: Optional[int] = None
    by_head: bool = False
    groups: int = 1


REPLICATED = ParamSpec("replicated")
_BLOCK_SPECS = {
    "attn.qkv.weight": ParamSpec("column", 0, True, 3),
    "attn.qkv.bias": ParamSpec("column", 0, True, 3),
    "attn.q_bias": ParamSpec("column", 0, True),
    "attn.v_bias": ParamSpec("column", 0, True),
    "attn.q_norm.weight": ParamSpec("column", 0, True),
    "attn.k_norm.weight": ParamSpec("column", 0, True),
    "attn.proj.weight": ParamSpec("row", 1, True),
    "mlp.fc1.weight": ParamSpec("column", 0),
    "mlp.fc1.bias": ParamSpec("column", 0),
    "mlp.fc2.weight": ParamSpec("row", 1),
}


def param_spec(name: str) -> ParamSpec:
    """The spec of a parameter of the port's ViT or InternVideo2 by name
    (``blocks.<i>.attn.qkv.weight``, ...): the block GEMMs and what goes
    with their heads are cut; everything else, the row-parallel biases
    (proj, fc2) included, is replicated."""
    parts = name.split(".")
    if len(parts) > 2 and parts[0] == "blocks" and parts[1].isdigit():
        return _BLOCK_SPECS.get(".".join(parts[2:]), REPLICATED)
    return REPLICATED


def vit_param_specs(names) -> Dict[str, ParamSpec]:
    """{name: ParamSpec} of the named parameters (names, a state dict or a
    module)."""
    if isinstance(names, torch.nn.Module):
        names = [n for n, _ in names.named_parameters()]
    return {n: param_spec(n) for n in names}


def padded_heads(num_heads: int, size: int) -> int:
    """``num_heads`` rounded up to a multiple of the model group's
    ``size``; raises where that would pad more heads than there are."""
    if size < 1:
        raise ValueError(f"model group of {size}")
    padded = -(-num_heads // size) * size
    if padded - num_heads > num_heads:
        raise ValueError(f"{num_heads} heads do not split over {size} model "
                         f"ranks: padding to {padded} would add more heads "
                         f"than there are")
    return padded


def local_hidden(hidden: int, size: int) -> int:
    """A rank's share of the MLP's hidden width."""
    if hidden % size:
        raise ValueError(f"MLP hidden width {hidden} does not split over "
                         f"{size} model ranks")
    return hidden // size


def _head_view(t: torch.Tensor, spec: ParamSpec, num_heads: int):
    """t with its cut axis split as (groups, heads, rest)."""
    shape = t.shape
    d = spec.dim
    return t.reshape(shape[:d] + (spec.groups, num_heads, -1)
                     + shape[d + 1:])


def shard_tensor(t: torch.Tensor, spec: ParamSpec, num_heads: int,
                 size: int, rank: int) -> torch.Tensor:
    """A whole tensor -> model rank ``rank``'s share (a new tensor)."""
    if spec.split == "replicated" or size == 1 and not spec.by_head:
        return t.clone()
    d = spec.dim
    if not spec.by_head:
        n = local_hidden(t.shape[d], size)
        return t.narrow(d, rank * n, n).clone()
    hp = padded_heads(num_heads, size)
    hl = hp // size
    v = _head_view(t, spec, num_heads)
    lo = rank * hl
    real = max(0, min(hl, num_heads - lo))
    mine = v.narrow(d + 1, min(lo, num_heads), real)
    if real < hl:
        pad = list(mine.shape)
        pad[d + 1] = hl - real
        mine = torch.cat([mine, mine.new_zeros(pad)], dim=d + 1)
    shape = list(t.shape)
    shape[d] = t.shape[d] * hl // num_heads
    return mine.reshape(shape).clone()


def merge_tensors(shards: Sequence[torch.Tensor], spec: ParamSpec,
                  num_heads: int) -> torch.Tensor:
    """Every model rank's share, in rank order -> the whole tensor, its
    padding stripped."""
    if spec.split == "replicated":
        return shards[0]
    d = spec.dim
    if not spec.by_head:
        return torch.cat(list(shards), dim=d)
    size = len(shards)
    hl = padded_heads(num_heads, size) // size
    views = [_head_view(s, spec, hl) for s in shards]
    whole = torch.cat(views, dim=d + 1).narrow(d + 1, 0, num_heads)
    shape = list(shards[0].shape)
    shape[d] = shards[0].shape[d] * num_heads // hl
    return whole.reshape(shape)


def shard_state_dict(state: Dict[str, torch.Tensor], num_heads: int,
                     size: int, rank: int) -> Dict[str, torch.Tensor]:
    """A whole model's state dict -> model rank ``rank``'s of ``size``."""
    return {n: shard_tensor(t, param_spec(n), num_heads, size, rank)
            for n, t in state.items()}


def merge_state_dicts(states: Sequence[Dict[str, torch.Tensor]],
                      num_heads: int) -> Dict[str, torch.Tensor]:
    """Every model rank's state dict, in rank order -> the whole one."""
    return {n: merge_tensors([s[n] for s in states], param_spec(n),
                             num_heads)
            for n in states[0]}


def gather_state_dict(state: Dict[str, torch.Tensor], num_heads: int,
                      tp: ModelParallel) -> Dict[str, torch.Tensor]:
    """This rank's state dict -> the whole one, unpadded, on every rank of
    the model group (a collective: every model rank calls it; replicated
    tensors are taken from this rank; over gloo through the host)."""
    out = {}
    for n, t in state.items():
        spec = param_spec(n)
        out[n] = (t if spec.split == "replicated"
                  else merge_tensors(tp.all_gather(t), spec, num_heads))
    return out


def sharded_names(names) -> List[str]:
    """The names among ``names`` whose tensors are cut over the model
    group."""
    return [n for n in names if param_spec(n).split != "replicated"]


# --------------------------------------------------------- seeded weights --

@torch.no_grad()
def init_sharded(model, whole: torch.nn.Module, generator: torch.Generator,
                 num_heads: int, tp: ModelParallel) -> None:
    """Fill the tensor-parallel ``model`` with its share of the weights
    ``whole.init_weights(generator)`` draws, one block at a time: ``whole``
    is the same model without tensor parallelism on the meta device; each
    block is materialized on the generator's device, initialised, sliced
    into ``model`` and dropped before the next, the rest of ``whole``
    stays materialized (embeddings, head).  The draws are those of one
    whole-model init, in its order."""
    dev = generator.device
    blocks = whole.blocks
    for name, child in whole.named_children():
        if name != "blocks":
            child.to_empty(device=dev)
    whole.to_empty(device=dev, recurse=False)

    def wrap(i, blk):
        init = blk.init_weights

        def run(gen):
            blk.to_empty(device=dev)
            init(gen)
            state = {n: shard_tensor(t, param_spec(f"blocks.{i}.{n}"),
                                     num_heads, tp.size, tp.rank)
                     for n, t in blk.state_dict().items()}
            model.blocks[i].load_state_dict(state)
            blk.to(device="meta")
        return run

    for i, blk in enumerate(blocks):
        blk.init_weights = wrap(i, blk)
    whole.init_weights(generator)
    rest = {n: t for n, t in whole.state_dict().items()
            if not n.startswith("blocks.")}
    missing, unexpected = model.load_state_dict(rest, strict=False)
    missing = [n for n in missing if not n.startswith("blocks.")]
    if missing or unexpected:
        raise ValueError(f"the whole model's state does not fit: missing "
                         f"{missing}, unexpected {unexpected}")
