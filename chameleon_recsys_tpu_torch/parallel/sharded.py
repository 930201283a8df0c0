"""The sharded NAR train and eval steps: the multi-GPU production path.

Port of ``chameleon_recsys_tpu/parallel/sharded.py``.  The JAX package jits
the single-device step functions with explicit shardings over its
``(data x model)`` mesh and lets GSPMD insert the collectives.  Here each
rank runs ``train/steps.py``'s ``train_step`` / ``eval_step`` on its block
of the global batch with a ``StepShard``, which writes out what GSPMD
inserts:

  * global clicks: the rank's click columns are all-gathered over the data
    group; the candidate pool, the stream update, the reference time and
    the dynamic features' fallback statistics take the global batch, so the
    replicated stream stays bit-identical on every rank;
  * draws in lockstep: every rank holds the same generator state and draws
    every tensor at its global shape, in the single-device order, and keeps
    its block;
  * compaction per rank at ``capacity / dp``: group ``data_index`` of the
    single-device grouped step;
  * the losses divide by the global valid-click count; the L2 term is added
    on data index 0 only, so that its gradient counts once;
  * gradients summed over the data group in a few flat buckets, in the
    parameters' order (not averaged), and with a model axis the replicated
    ones broadcast from model index 0, so that replicated parameters and
    Adam's moments stay bit-identical on every rank;
  * row-sharded tables (model parallelism > 1): a rank holds its rows of
    every table the rule shards (``parallel/mesh.py``) and their Adam
    moments.  A lookup gathers the owned rows, zeros for the rest, and sums
    over the model group (every model rank has the same ids); its backward
    adds into the owned rows only.  A sharded parameter that the model uses
    whole (a dense kernel, at a small ``min_rows``) is all-gathered for the
    forward and its gradient sliced back;
  * the eval metrics are summed over the data group; the fetches stay the
    rank's rows.

The layout of the train state follows JAX's rule on the Flax layout of each
parameter (``convert.jax_row_dim``): a Flax Dense kernel ``[in, out]`` is an
``nn.Linear`` weight ``[out, in]``, whose Flax rows are its columns.
"""
from __future__ import annotations

import re
from typing import Any, Dict, List, Mapping, NamedTuple, Optional

import numpy as np
import torch
from torch import nn

from ..convert import jax_row_dim
from ..models.towers import gather_rows
from ..ops.sampling import SamplerUniforms
from ..train import steps
from ..train.loss import l2_regularization
from ..utils.profiling import span
from . import distributed as coll
from .mesh import MeshPlan, RowShard, batch_sharding, params_sharding

# the parameters the model reads through ``gather_rows``: row-sharded, they
# are looked up where they lie; every other sharded parameter is gathered whole
_LOOKUP_TABLE = re.compile(
    r"(item_clicked_embedding|(article_metadata_towers|user_context_towers)"
    r"\.embeddings\.\w+)\.weight")
# the gradient buckets' size: a few coalesced all-reduces a step
BUCKET_BYTES = 32 << 20
# the click columns the global batch needs on every rank
_GLOBAL_COLUMNS = ("item_clicked", "label_next_item", "label_last_item",
                   "event_timestamp", "session_size")


class ParamShard(NamedTuple):
    """A parameter's rows on this rank, along its torch axis ``dim``."""

    dim: int
    rows: RowShard

    def narrow(self, tensor: torch.Tensor) -> torch.Tensor:
        return tensor.narrow(self.dim, self.rows.lo, self.rows.hi - self.rows.lo)


class _Shape(NamedTuple):
    shape: tuple


def model_sharding(plan: MeshPlan, model: nn.Module, min_rows: int = 4096
                   ) -> Dict[str, Optional[ParamShard]]:
    """{parameter name: ``ParamShard`` or None}: JAX's ``params_sharding``
    on each parameter's Flax layout."""
    shapes, dims = {}, {}
    for name, param in model.named_parameters():
        dims[name] = jax_row_dim(name) if param.ndim == 2 else 0
        shape = tuple(param.shape)
        shapes[name] = _Shape(shape[::-1] if dims[name] else shape)
    return {
        name: None if spec is None else ParamShard(dims[name], spec)
        for name, spec in params_sharding(plan, shapes, min_rows).items()
    }


def _resolve(model: nn.Module, name: str):
    module_name, _, attr = name.rpartition(".")
    return (model.get_submodule(module_name) if module_name else model), attr


class ShardedNARPrograms(NamedTuple):
    """The sharded steps of one model on one rank (``shard_nar_programs``)."""

    plan: MeshPlan
    state_sharding: Dict[str, Optional[ParamShard]]
    ace_sharding: Optional[RowShard]
    min_rows: int

    # -- the steps ----------------------------------------------------------
    def train_step(self, state, batch, ace_matrix, metadata, *,
                   uniforms: Optional[SamplerUniforms] = None):
        """``train.steps.train_step`` on this rank's block ``batch`` of the
        global batch; ``uniforms`` at the global batch's shape."""
        shard = StepShard(self, state.model, batch, ace_matrix)
        return steps.train_step(state, batch, ace_matrix, metadata,
                                uniforms=uniforms, shard=shard)

    def eval_step(self, model, stream, batch, ace_matrix, metadata, *, generator,
                  fetch_full_ranking: bool = True,
                  uniforms: Optional[SamplerUniforms] = None):
        """``train.steps.eval_step`` on this rank's block: the metrics the
        global batch's, the fetches the rank's rows."""
        shard = StepShard(self, model, batch, ace_matrix)
        return steps.eval_step(model, stream, batch, ace_matrix, metadata,
                               generator=generator,
                               fetch_full_ranking=fetch_full_ranking,
                               uniforms=uniforms, shard=shard)

    # -- placement ------------------------------------------------------------
    def local_ace(self, ace_matrix: torch.Tensor) -> torch.Tensor:
        """The rank's rows of the (whole) ACE matrix."""
        if self.ace_sharding is None:
            return ace_matrix
        return ace_matrix[self.ace_sharding.lo: self.ace_sharding.hi].contiguous()

    def gather_data(self, tensor: torch.Tensor) -> torch.Tensor:
        """Every data rank's ``tensor`` (the same shape on each), concatenated
        on axis 0 in data-index order: the global batch's rows."""
        return torch.cat(coll.all_gather(tensor, self.plan.data_group), 0)

    def full_tensors(self, tensors: Mapping[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
        """{parameter name: the rank's tensor (a parameter, or one of its Adam
        moments)} -> the whole tensors, the row shards all-gathered over the
        model group (every rank calls it)."""
        out = {}
        for name, tensor in tensors.items():
            spec = self.state_sharding.get(name)
            if spec is None or tensor.ndim == 0:
                out[name] = tensor
            else:
                parts = coll.all_gather(tensor.detach(), self.plan.model_group)
                out[name] = torch.cat(parts, spec.dim)
        return out

    def local_tensors(self, tensors: Mapping[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
        """{parameter name: the whole tensor} -> the rank's rows of each."""
        return {
            name: tensor if self.state_sharding.get(name) is None or tensor.ndim == 0
            else self.state_sharding[name].narrow(tensor).contiguous()
            for name, tensor in tensors.items()
        }


def shard_nar_programs(plan: MeshPlan, model: nn.Module, ace_matrix,
                       min_rows: int = 4096) -> ShardedNARPrograms:
    """The sharded steps for ``model`` (a whole ``NARModel``, the same on
    every rank): replaces each parameter the rule shards by the rank's rows
    of it, in place, before an optimizer is made over the parameters.  The
    harness keeps ``programs.local_ace(ace_matrix)`` on the device."""
    cfg = model.cfg
    dp = plan.data_parallelism
    if cfg.batch_size % dp:
        raise ValueError(f"batch_size {cfg.batch_size} not divisible by "
                         f"data_parallelism {dp}")
    if cfg.train_valid_row_capacity is not None and (
            cfg.train_valid_row_capacity % dp
            or max(cfg.train_compaction_groups, 1) % dp):
        raise ValueError(
            "under a mesh train_valid_row_capacity and train_compaction_groups "
            f"must be multiples of data_parallelism {dp} (the CLIs set the "
            "groups to it)")
    sharding = model_sharding(plan, model, min_rows)
    with torch.no_grad():
        for name, spec in sharding.items():
            if spec is not None:
                module, attr = _resolve(model, name)
                local = spec.narrow(getattr(module, attr).detach()).clone()
                setattr(module, attr, nn.Parameter(local))
    ace_rows = params_sharding(plan, {"ace": _Shape(tuple(np.shape(ace_matrix)))},
                               min_rows)["ace"]
    return ShardedNARPrograms(plan, sharding, ace_rows, min_rows)


def put_batch(programs: ShardedNARPrograms, np_batch) -> Dict[str, torch.Tensor]:
    """This rank's rows of one global numpy batch, on the rank's device."""
    rows = batch_sharding(programs.plan, np_batch)
    return {k: torch.from_numpy(np.ascontiguousarray(v[rows[k]])).to(programs.plan.device)
            for k, v in np_batch.items()}


# ---------------------------------------------------------------------------
class _ShardedLookup(torch.autograd.Function):
    """Rows of a row-sharded table: the owned rows, zeros for the rest,
    summed over the model group; the backward adds into the owned rows
    only (each model rank holds the same cotangent)."""

    @staticmethod
    def forward(ctx, table, ids, rows: RowShard, group):
        local, own = _owned(ids, rows, table.shape[0])
        out = torch.where(own[..., None], table[local], torch.zeros((), dtype=table.dtype,
                                                                    device=table.device))
        coll.all_reduce(out, group)
        ctx.save_for_backward(local, own)
        ctx.table_rows = table.shape[0]
        return out

    @staticmethod
    def backward(ctx, g):
        local, own = ctx.saved_tensors
        width = g.shape[-1]
        sel = own.reshape(-1)
        acc = torch.zeros((ctx.table_rows, width), dtype=torch.float32, device=g.device)
        acc.index_add_(0, local.reshape(-1)[sel], g.reshape(-1, width)[sel].float())
        return acc.to(g.dtype), None, None, None


def _owned(ids: torch.Tensor, rows: RowShard, n_local: int):
    """ids (clamped into the whole table, as XLA clamps a gather) -> the
    local row of each (clamped into the shard) and whether this rank owns it."""
    local = ids.long().clamp(0, rows.rows - 1) - rows.lo
    own = (local >= 0) & (local < n_local)
    return local.clamp(0, n_local - 1), own


class _GatherRows(torch.autograd.Function):
    """A row-sharded parameter whole, for a forward that uses it whole: the
    shards all-gathered over the model group; the backward keeps the
    rank's rows of the (replicated) gradient."""

    @staticmethod
    def forward(ctx, local, spec: ParamShard, group):
        ctx.spec = spec
        return torch.cat(coll.all_gather(local, group), spec.dim)

    @staticmethod
    def backward(ctx, g):
        return ctx.spec.narrow(g).contiguous(), None, None


class StepShard:
    """One step's view of the mesh on this rank, for ``train.steps`` and
    the model (``NARAux.shard``).

    ``batch``: the global batch's click columns (all-gathered over the data
    group); ``sessions``: the rank's block of the global batch's sessions;
    ``valid_clicks`` (f32) and ``sessions_count``: the global batch's
    counts; ``counts_l2``: whether this rank adds the L2 term."""

    def __init__(self, programs: ShardedNARPrograms, model: nn.Module, batch,
                 ace_matrix):
        plan = self.plan = programs.plan
        self.programs = programs
        b, t = batch["item_clicked"].shape
        self.sessions = slice(plan.data_index * b, (plan.data_index + 1) * b)
        self.batch = _global_columns(programs, batch)
        self.valid_clicks = steps.valid_click_mask(
            self.batch["session_size"], t).sum().to(torch.float32)
        self.sessions_count = (self.batch["session_size"] > 0).sum()
        self.counts_l2 = plan.data_index == 0
        sharding = programs.state_sharding
        # in the parameters' order: every rank makes the same collectives in
        # the same order
        sharded = [n for n, spec in sharding.items() if spec is not None]
        self.sharded_names = frozenset(sharded)
        params = dict(model.named_parameters())
        self.tables = {id(params[n]): sharding[n].rows for n in sharded
                       if _LOOKUP_TABLE.fullmatch(n)}
        if programs.ace_sharding is not None:
            self.tables[id(ace_matrix)] = programs.ace_sharding
        self.whole = {n: sharding[n] for n in sharded if not _LOOKUP_TABLE.fullmatch(n)}

    # -- the model's hooks -----------------------------------------------------
    def gather_rows(self, table: torch.Tensor, ids: torch.Tensor) -> torch.Tensor:
        rows = self.tables.get(id(table))
        if rows is None:
            return gather_rows(table, ids)
        return _ShardedLookup.apply(table, ids, rows, self.plan.model_group)

    def local_rows(self, tensor: torch.Tensor, axis: int = 0) -> torch.Tensor:
        """The rank's block of a global-batch tensor along ``axis``."""
        n = tensor.shape[axis] // self.plan.data_parallelism
        return tensor.narrow(axis, self.plan.data_index * n, n)

    def gather_data(self, tensor: torch.Tensor) -> torch.Tensor:
        return self.programs.gather_data(tensor)

    def click_block(self, uniforms: SamplerUniforms) -> SamplerUniforms:
        """Global-shape sampler uniforms with the rank's block of the
        per-row click keys."""
        return uniforms._replace(click=self.local_rows(uniforms.click))

    def model_call(self, model: nn.Module):
        """``model`` itself, or (with sharded parameters it uses whole) a
        call of it with those parameters gathered."""
        if not self.whole:
            return model

        def call(*args, **kwargs):
            params = dict(model.named_parameters())
            whole = {n: _GatherRows.apply(params[n], spec, self.plan.model_group)
                     for n, spec in self.whole.items()}
            return torch.func.functional_call(model, whole, args, kwargs)

        return call

    # -- losses, gradients, metrics ---------------------------------------------
    def l2(self, model: nn.Module, weight_decay: float):
        """(the L2 term over the rank's parameters, for its backward; the
        whole model's L2 term, the sharded tables' sums over the model
        group, detached)."""
        own = l2_regularization(model, weight_decay)
        if not self.sharded_names:
            return own, own.detach()
        with torch.no_grad():
            sharded = l2_regularization(model, weight_decay, self.sharded_names)
            sharded = coll.all_reduce(sharded.reshape(1).clone(), self.plan.model_group)[0]
            rest = l2_regularization(
                model, weight_decay,
                {n for n, _ in model.named_parameters()} - self.sharded_names)
        return own, rest.to(sharded.device) + sharded

    def data_sum(self, values: List[torch.Tensor]) -> List[torch.Tensor]:
        """Scalars summed over the data group, in one all-reduce."""
        packed = torch.stack([v.to(torch.float32) for v in values])
        return list(coll.all_reduce(packed, self.plan.data_group).unbind())

    def sync_grads(self, model: nn.Module) -> None:
        """Sum every gradient over the data group (flat buckets, parameter
        order); with a model axis, broadcast the replicated ones from model
        index 0.  The span ``nar.train_step.sync`` holds it."""
        with span("nar.train_step.sync"):
            named = list(model.named_parameters())
            _bucketed([p.grad for _, p in named],
                      lambda flat: coll.all_reduce(flat, self.plan.data_group))
            if self.plan.model_parallelism > 1:
                _bucketed([p.grad for n, p in named if n not in self.sharded_names],
                          lambda flat: coll.broadcast(flat, self.plan.model_root,
                                                      self.plan.model_group))


def _bucketed(grads: List[torch.Tensor], reduce) -> None:
    """``reduce`` (in place) each run of consecutive gradients of one dtype
    up to ``BUCKET_BYTES``, flattened into one buffer; the results copied
    back."""
    bucket: List[torch.Tensor] = []
    size = 0

    def flush():
        if not bucket:
            return
        flat = torch.cat([g.reshape(-1) for g in bucket])
        reduce(flat)
        offset = 0
        for g in bucket:
            g.copy_(flat[offset: offset + g.numel()].view_as(g))
            offset += g.numel()
        bucket.clear()

    for g in grads:
        nbytes = g.numel() * g.element_size()
        if bucket and (size + nbytes > BUCKET_BYTES or g.dtype != bucket[0].dtype):
            flush()
            size = 0
        bucket.append(g)
        size += nbytes
    flush()


def _global_columns(programs: ShardedNARPrograms, batch) -> Dict[str, torch.Tensor]:
    """The global batch's click columns: the ranks' blocks all-gathered
    over the data group in one buffer."""
    b = batch["item_clicked"].shape[0]
    local = [batch[c].reshape(b, -1) for c in _GLOBAL_COLUMNS]
    widths = [x.shape[1] for x in local]
    packed = programs.gather_data(torch.cat([x.to(torch.int64) for x in local], 1))
    out = {}
    for name, x, part in zip(_GLOBAL_COLUMNS, local,
                             torch.split(packed, widths, dim=1)):
        out[name] = part.reshape((-1,) + tuple(batch[name].shape[1:])).to(x.dtype)
    return out
