"""The train step (the port of the JAX package's ``train/step.py``):
forward, the hand-written backward of the recurrence (``ops.lstm``),
autograd elsewhere, the optax-rule update (``train.optim``) and the
Polyak average, on the params' device.

Batches are dicts of tensors on that device.  With ``feature_banks``
(stream -> [V, C, F], plus ``video_tef`` for Charades) a batch carries
``video_idx`` only and clip features are gathered from the banks.
``make_train_multi_step`` runs K steps per call on a stacked chunk and
averages their metrics without a host sync inside the chunk: the model's
static tables are moved to the device once (``tables_on``) and no step
copies from the host.

With ``mesh`` (data parallel over its "data" axis, one process driving
every device, as the JAX package's jit over a mesh): the params, optimizer
state and Polyak average live on the axis's lead device; each mesh
position holds a replica of the trainable leaves (``_Replicas``) and runs
the embedding half of the loss (``embed_batch``) on its rows of the batch
(``place_batch``: JAX's ``P("data")``).  The embeddings are gathered to the
lead in shard order and the loss is the global-batch loss, as the
reference's (InfoNCE's in-batch negatives span all B queries).  One
``autograd.grad`` gives every replica's gradients, which are summed onto
the lead in shard order (deterministic, as a psum); the update and the
average run on the lead, and the replicas are overwritten from it.
"""

from __future__ import annotations

from typing import Dict, List, NamedTuple, Optional

import torch

from vfr_tpu_torch.config import TrainConfig
from vfr_tpu_torch.data.features import banks_by_device
from vfr_tpu_torch.models.mcn import (
    Model,
    embed_moments,
    embed_queries_multi,
    tables_on,
)
from vfr_tpu_torch.parallel.mesh import distinct, replicate, split_batch
from vfr_tpu_torch.train.loss import compute_loss
from vfr_tpu_torch.train.optim import Optimizer, apply_updates, global_norm
from vfr_tpu_torch.utils.tree import flatten, unflatten

# the batch keys the loss reads over the whole batch (the per-step tau
# included); under a mesh they go to the lead whole
LOSS_KEYS = ("target", "video_idx", "window_mask", "hard_neg_video",
             "tau_now")


class ShardedBatch(NamedTuple):
    """A batch (or a [K, B, ...] chunk) placed for the data-parallel step:
    ``shards[i]`` holds position i's rows of every batch-axis key on its
    device, ``whole`` the ``LOSS_KEYS`` present, whole, on the lead."""

    shards: List[Dict[str, torch.Tensor]]
    whole: Dict[str, torch.Tensor]


def place_batch(batch, devices, axis: int = 0, copy=None) -> ShardedBatch:
    """``batch`` (numpy arrays or tensors; its batch axis is ``axis``: 0 for
    a batch, 1 for a chunk) split over ``devices`` (``split_batch``), the
    ``LOSS_KEYS`` also copied whole to ``devices[0]``; ``copy(value,
    device)`` places a value (the prefetcher passes its pinned copy).  A
    batch size that is not a multiple of the device count raises."""
    B, n = batch["tokens"].shape[axis], len(devices)
    if B % n:
        raise ValueError(
            f"batch size {B} is not a multiple of the {n} devices of the "
            "mesh's \"data\" axis")
    if copy is None:
        def copy(v, d):
            return torch.as_tensor(v).to(d)
    shards = split_batch({k: v for k, v in batch.items() if k != "tau_now"},
                         devices, axis, copy)
    return ShardedBatch(shards, {k: copy(batch[k], devices[0])
                                 for k in LOSS_KEYS if k in batch})


def embed_batch(params: Dict, model: Model, batch: Dict[str, torch.Tensor],
                dropout_keep=None,
                feature_banks: Optional[Dict[str, torch.Tensor]] = None):
    """(q [S, B, d], moments stream -> [B, P, d], mined negatives stream ->
    [B, Hn, d] or None): the embedding half of the loss, which runs per
    shard under a mesh.  ``dropout_keep`` [B, H] bool (or the batch's
    ``dropout_keep``) is query dropout's keep mask."""
    if dropout_keep is None:
        dropout_keep = batch.get("dropout_keep")
    if feature_banks is not None:
        vidx = batch["video_idx"].long()
        feats = {s: feature_banks[s][vidx] for s in model.streams}
    else:
        feats = {s: batch[s] for s in model.streams}
    q = embed_queries_multi(params, model, batch["tokens"], batch["lengths"],
                            dropout_keep=dropout_keep)
    m = embed_moments(params, model, feats, tef=batch.get("tef"),
                      context_mask=batch.get("context_mask"))
    hard_m = None
    hv = batch.get("hard_neg_video")
    if hv is not None and feature_banks is not None:
        # the mined (video, proposal) pairs embedded with the current
        # params: only the mined proposal of each video, through its
        # pooling-matrix row (and TEF row)
        hp = batch["hard_neg_prop"]
        B, Hn = hv.shape
        hv_safe = torch.clamp(hv, min=0).reshape(-1).long()
        hp_safe = torch.clamp(hp, min=0).reshape(-1).long()
        dev = hv.device
        feats_h = {s: feature_banks[s][hv_safe] for s in model.streams}
        pm_h = torch.as_tensor(model.pool_matrix, dtype=torch.float32,
                               device=dev)[hp_safe][:, None, :]
        tef_h = None
        if model.cfg.use_tef:
            if "video_tef" in feature_banks:
                # Charades: the mined video's TEF row, then its window's
                tef_bank = feature_banks["video_tef"][hv_safe]  # [B*Hn, P, 2]
                tef_h = torch.gather(
                    tef_bank, 1, hp_safe[:, None, None].expand(-1, 1, 2))
            else:
                tef_h = torch.as_tensor(model.tef, dtype=torch.float32,
                                        device=dev)[hp_safe][:, None, :]
        m_h = embed_moments(params, model, feats_h, tef=tef_h,
                            pool_matrix=pm_h)                 # [B*Hn, 1, d]
        hard_m = {s: m_h[s][:, 0].reshape(B, Hn, -1) for s in model.streams}
    return q, m, hard_m


def _batch_loss(model: Model, tcfg: TrainConfig, q, m, hard_m, batch,
                params):
    """``compute_loss`` of embeddings over the batch's ``LOSS_KEYS``.
    Temperature: a scheduled per-step tau rides the batch; else the
    learnable log_tau param; else tcfg.temperature."""
    if "tau_now" in batch:
        log_tau = torch.log(batch["tau_now"].to(torch.float32))
    else:
        log_tau = params.get("log_tau")
    return compute_loss(
        model, tcfg, q, m,
        target=batch["target"],
        video_idx=batch["video_idx"],
        proposal_mask=batch.get("window_mask"),
        hard_moments=hard_m,
        hard_valid=None if hard_m is None else batch["hard_neg_video"] >= 0,
        log_tau=log_tau,
    )


def loss_from_batch(
    params: Dict, model: Model, tcfg: TrainConfig,
    batch: Dict[str, torch.Tensor], dropout_keep=None,
    feature_banks: Optional[Dict[str, torch.Tensor]] = None,
):
    """(loss, aux) of one batch on one device."""
    q, m, hard_m = embed_batch(params, model, batch, dropout_keep,
                               feature_banks)
    return _batch_loss(model, tcfg, q, m, hard_m, batch, params)


def _ema_update(ema, params, decay: float):
    """One Polyak step in place: ema + (1 - d) * (params - ema) over the
    whole tree, d in f32."""
    if decay <= 0 or ema is None:
        return ema
    c = float(torch.tensor(1.0) - torch.tensor(decay, dtype=torch.float32))
    _, e = flatten(ema)
    _, p = flatten(params)
    diff = torch._foreach_sub(p, e)
    torch._foreach_mul_(diff, c)
    torch._foreach_add_(e, diff)
    return ema


def _check_ema_arg(tcfg: TrainConfig, ema) -> None:
    """ema_decay > 0 makes the ema tree a required argument: without it
    the average a config asks for would silently not be kept."""
    if tcfg.ema_decay > 0 and ema is None:
        raise ValueError(
            f"TrainConfig.ema_decay={tcfg.ema_decay} > 0 but no ema tree "
            "was passed to the train step; seed it from a copy of the "
            "initial params and thread the returned tree through every call")


def _frozen(model: Model, paths) -> List[bool]:
    """The leaves no gradient trains (the GloVe table when frozen)."""
    return [model.freeze_embeddings and p == ("embeddings",) for p in paths]


def _grads(params, model, tcfg, batch, banks):
    """(aux, grads): grads a tree like params, None where no gradient
    flows (the frozen GloVe table); grad_norm in aux is pre-clip."""
    paths, leaves = flatten(params)
    frozen = _frozen(model, paths)
    req = [l if f else l.detach().requires_grad_(True)
           for l, f in zip(leaves, frozen)]
    with torch.enable_grad():
        loss, aux = loss_from_batch(unflatten(paths, req), model, tcfg,
                                    batch, feature_banks=banks)
        wrt = [r for r, f in zip(req, frozen) if not f]
        got = iter(torch.autograd.grad(loss, wrt, allow_unused=True))
    grads = []
    for r, f in zip(req, frozen):
        g = None if f else next(got)
        grads.append(torch.zeros_like(r) if g is None and not f else g)
    aux = dict(aux)
    aux["grad_norm"] = global_norm([g for g in grads if g is not None])
    return aux, unflatten(paths, grads)


def _device_model(model: Model):
    """device -> the same model with its tables on that device, moved once
    per device."""
    cache = {}

    def on(dev):
        if dev not in cache:
            cache[dev] = tables_on(model, dev)
        return cache[dev]
    return on


def _one_step(params, opt_state, ema, batch, model, tcfg, optimizer, banks):
    aux, grads = _grads(params, model, tcfg, batch, banks)
    updates, opt_state = optimizer.update(grads, opt_state, params)
    params = apply_updates(params, updates)
    ema = _ema_update(ema, params, tcfg.ema_decay)
    return params, opt_state, ema, aux


class _Replicas:
    """The data-parallel step's copies of the params: the trainable leaves
    once per mesh position (distinct tensors on a repeated device, so the
    reduction and the broadcast run as across cards), the frozen leaves
    once per distinct device.  ``sync`` copies a lead tree that the
    replicas do not hold yet (the first call, a resumed run);
    ``broadcast`` overwrites them from the updated lead tree."""

    def __init__(self, model: Model, devices):
        self.model, self.devices = model, devices
        self.src = None          # the lead tree the replicas hold
        self.paths = self.mask = None    # its leaf paths, frozen or not
        self.leaves = None       # per position: its trainable leaves
        self.frozen = None       # device -> frozen leaves

    def _trainable(self, leaves):
        return [l for l, f in zip(leaves, self.mask) if not f]

    def sync(self, params) -> None:
        if params is self.src:
            return
        self.paths, leaves = flatten(params)
        self.mask = _frozen(self.model, self.paths)
        held = unflatten([p for p, f in zip(self.paths, self.mask) if not f],
                         self._trainable(leaves))
        self.leaves = [flatten(t)[1] for t in replicate(held, self.devices)]
        self.frozen = {d: [l.to(d) for l, f in zip(leaves, self.mask) if f]
                       for d in distinct(self.devices)}
        self.src = params

    def broadcast(self, params) -> None:
        train = self._trainable(flatten(params)[1])
        for leaves in self.leaves:
            torch._foreach_copy_(leaves, train, non_blocking=True)
        self.src = params

    def tree(self, i: int, leaves=None) -> Dict:
        """Position i's full tree (its trainable ``leaves`` if given)."""
        it = iter(self.leaves[i] if leaves is None else leaves)
        fz = iter(self.frozen[self.devices[i]])
        return unflatten(self.paths, [next(fz) if f else next(it)
                                      for f in self.mask])


def _shard_forward(reps: _Replicas, on_device, batch: ShardedBatch, banks,
                   req):
    """Every position's ``embed_batch`` of its shard with its replica
    (trainable leaves ``req[i]``), queued on its device in shard order."""
    return [embed_batch(reps.tree(i, req[i]), on_device(d), shard,
                        feature_banks=banks[d])
            for i, (d, shard) in enumerate(zip(reps.devices, batch.shards))]


def _gather_loss(reps: _Replicas, on_device, tcfg, batch: ShardedBatch,
                 outs, req):
    """(loss, aux) on the lead over the shards' embeddings concatenated in
    shard order (JAX's ``P("data")`` row order) and the whole batch's loss
    keys; a learned temperature is position 0's leaf."""
    lead = reps.devices[0]

    def gather(parts, dim=0):
        return torch.cat([p.to(lead, non_blocking=True) for p in parts],
                         dim=dim)
    q = gather([o[0] for o in outs], dim=1)
    m = {s: gather([o[1][s] for o in outs]) for s in outs[0][1]}
    hard_m = (None if outs[0][2] is None else
              {s: gather([o[2][s] for o in outs]) for s in outs[0][2]})
    return _batch_loss(on_device(lead), tcfg, q, m, hard_m, batch.whole,
                       reps.tree(0, req[0]))


def _reduce(reps: _Replicas, got, req):
    """The positions' gradients (``got``, flat in position order, None
    where none flowed) summed onto the lead in shard order: a tree like
    the lead's params, None at frozen leaves."""
    lead = reps.devices[0]
    nt = len(req[0])
    grads = [torch.zeros_like(r) if g is None else g
             for g, r in zip(got[:nt], req[0])]
    for i in range(1, len(req)):
        # out of place: autograd may hand one tensor to two leaves
        part = got[i * nt:(i + 1) * nt]
        live = [j for j, g in enumerate(part) if g is not None]
        summed = torch._foreach_add([grads[j] for j in live],
                                    [part[j].to(lead, non_blocking=True)
                                     for j in live])
        for j, g in zip(live, summed):
            grads[j] = g
    it = iter(grads)
    return unflatten(reps.paths, [None if f else next(it)
                                  for f in reps.mask])


def _dp_grads(reps: _Replicas, on_device, tcfg, batch: ShardedBatch, banks):
    """(aux, grads) of the global batch: ``_shard_forward``,
    ``_gather_loss``, one ``autograd.grad`` over every replica's leaves and
    ``_reduce``; grad_norm in aux is pre-clip."""
    req = [[t.detach().requires_grad_(True) for t in leaves]
           for leaves in reps.leaves]
    with torch.enable_grad():
        outs = _shard_forward(reps, on_device, batch, banks, req)
        loss, aux = _gather_loss(reps, on_device, tcfg, batch, outs, req)
        got = torch.autograd.grad(loss, [t for r in req for t in r],
                                  allow_unused=True)
    grads = _reduce(reps, got, req)
    aux = dict(aux)
    aux["grad_norm"] = global_norm([g for g in flatten(grads)[1]
                                    if g is not None])
    return aux, grads


def _stepper(model: Model, tcfg: TrainConfig, optimizer: Optimizer, mesh,
             feature_banks):
    """(one_step(params, opt_state, ema, batch) -> (params, opt_state, ema,
    aux), place(batch, axis) -> the batch as one_step takes it, replicas
    or None)."""
    on_device = _device_model(model)
    if mesh is None:
        def one_step(params, opt_state, ema, batch):
            return _one_step(params, opt_state, ema, batch,
                             on_device(params["embeddings"].device), tcfg,
                             optimizer, feature_banks)
        return one_step, lambda batch, axis: batch, None

    devices = mesh.axis_devices("data")
    reps = _Replicas(model, devices)
    banks = banks_by_device(feature_banks, devices)

    def one_step(params, opt_state, ema, batch):
        reps.sync(params)
        aux, grads = _dp_grads(reps, on_device, tcfg, batch, banks)
        updates, opt_state = optimizer.update(grads, opt_state, params)
        params = apply_updates(params, updates)
        ema = _ema_update(ema, params, tcfg.ema_decay)
        reps.broadcast(params)
        return params, opt_state, ema, aux

    def place(batch, axis):
        if isinstance(batch, ShardedBatch):
            return batch
        return place_batch(batch, devices, axis)
    return one_step, place, reps


def _with_replicas(fn, reps):
    """``fn`` with ``fn.replicas()``: each mesh position's full params tree
    (what its shard's forward reads), for checks that no replica drifted;
    [] without a mesh."""
    fn.replicas = lambda: ([] if reps is None or reps.src is None else
                           [reps.tree(i) for i in range(len(reps.devices))])
    return fn


def make_train_step(
    model: Model,
    tcfg: TrainConfig,
    optimizer: Optimizer,
    mesh=None,
    feature_banks: Optional[Dict[str, torch.Tensor]] = None,
):
    """``train_step(params, opt_state, batch[, ema])``.  Arity follows
    ``tcfg.ema_decay``: 0 -> ``(params, opt_state, metrics)``; > 0 ->
    ``(params, opt_state, ema, metrics)`` with ``ema`` required (updated
    in place).  With ``mesh`` the step is data parallel over its "data"
    axis (see the module docstring): params, optimizer state and ema on
    the lead; the batch dict (or a ``place_batch`` result) split by rows;
    ``feature_banks`` one bank dict (copied to each mesh device) or
    ``banks_to_device(mesh=)``'s."""
    one_step, place, reps = _stepper(model, tcfg, optimizer, mesh,
                                     feature_banks)

    def step(params, opt_state, batch, ema=None):
        _check_ema_arg(tcfg, ema)
        params, opt_state, ema, aux = one_step(params, opt_state, ema,
                                               place(batch, 0))
        if tcfg.ema_decay > 0:
            return params, opt_state, ema, aux
        return params, opt_state, aux

    return _with_replicas(step, reps)


def _step_of(chunk, k: int):
    """Step k of a stacked chunk (a dict or a ``ShardedBatch``)."""
    if isinstance(chunk, ShardedBatch):
        return ShardedBatch([{key: v[k] for key, v in s.items()}
                             for s in chunk.shards],
                            {key: v[k] for key, v in chunk.whole.items()})
    return {key: v[k] for key, v in chunk.items()}


def chunk_steps(chunk) -> int:
    """K of a stacked chunk (a dict or a ``ShardedBatch``)."""
    batch = chunk.shards[0] if isinstance(chunk, ShardedBatch) else chunk
    return batch["tokens"].shape[0]


def make_train_multi_step(
    model: Model,
    tcfg: TrainConfig,
    optimizer: Optimizer,
    mesh=None,
    feature_banks: Optional[Dict[str, torch.Tensor]] = None,
):
    """K optimizer steps per call over a stacked chunk (a batch dict with a
    leading step axis [K, B, ...], or under a mesh a ``place_batch(...,
    axis=1)`` result): ``multi_step(params, opt_state, chunk[, ema]) ->
    (params, opt_state[, ema], aux_mean)``, the per-step metrics averaged
    on the (lead) device, no host sync inside the chunk."""
    one_step, place, reps = _stepper(model, tcfg, optimizer, mesh,
                                     feature_banks)

    def multi_step(params, opt_state, chunk, ema=None):
        _check_ema_arg(tcfg, ema)
        chunk = place(chunk, 1)
        auxs = []
        for k in range(chunk_steps(chunk)):
            params, opt_state, ema, aux = one_step(params, opt_state, ema,
                                                   _step_of(chunk, k))
            auxs.append(aux)
        aux_mean = {key: torch.stack([a[key] for a in auxs]).mean(0)
                    for key in auxs[0]}
        if tcfg.ema_decay > 0:
            return params, opt_state, ema, aux_mean
        return params, opt_state, aux_mean

    return _with_replicas(multi_step, reps)
