"""Pipeline parallelism: a chain of stages spread over the ranks of a group.

The reference's two-view pipeline is a strict stage chain
detect -> match -> verify -> pose -> triangulate, run serially per pair
(SfM-GMS/SfMUtil.cpp:4-83). tpusfm software-pipelines it GPipe-style over a
1-D jax mesh (tpusfm/dist/pipeline.py): one SPMD program in which every
device steps through M + S - 1 ticks, runs its own stage under
``lax.switch``, masks the bubble ticks and rotates zero-initialised edge
buffers one hop a tick with ``ppermute``.

Here each stage is a rank of a ``torch.distributed`` group, so none of that
scaffolding is needed: rank s runs stage s only, on micro-batches 0..M-1 in
order. Stage 0 reads its micro-batch from the replicated inputs; stage
s > 0 receives it from rank s - 1 and sends its output on to rank s + 1.
The data dependencies alone give tpusfm's schedule (rank s works on
micro-batch t - s at tick t). A send is in flight while its rank computes
the next micro-batch. The last rank stacks its outputs and broadcasts them,
so every rank returns the same result.

Edges are tensors or tuples, lists and dataclasses of them (the port's
Features, Matches, TwoViewResult, ...), flattened in field order. Their
structure, dtypes and shapes travel once, in a header before the first
micro-batch; every later micro-batch must give the same.
"""
from __future__ import annotations

import dataclasses
import pickle

import torch

from tpusfm_torch.dist.group import Group, broadcast_from, recv_prev, send_next, wait


def _skeleton(x, leaves: list):
    """``x``'s structure with None where its tensors were; appends the
    tensors to ``leaves`` in field order."""
    if torch.is_tensor(x):
        leaves.append(x)
        return None
    if isinstance(x, (tuple, list)):
        return type(x)(_skeleton(v, leaves) for v in x)
    if dataclasses.is_dataclass(x) and not isinstance(x, type):
        return type(x)(**{f.name: _skeleton(getattr(x, f.name), leaves)
                          for f in dataclasses.fields(x)})
    raise TypeError(f"a pipeline edge holds tensors, tuples, lists and dataclasses, "
                    f"not {type(x).__name__}")


def _flatten(x) -> tuple:
    """(structure, tensors in field order) of an edge."""
    leaves = []
    return _skeleton(x, leaves), leaves


def _unflatten(skeleton, leaves):
    """``_flatten``'s inverse: the structure with the tensors of the
    iterator ``leaves`` in its slots."""
    if skeleton is None:
        return next(leaves)
    if isinstance(skeleton, (tuple, list)):
        return type(skeleton)(_unflatten(v, leaves) for v in skeleton)
    return type(skeleton)(**{f.name: _unflatten(getattr(skeleton, f.name), leaves)
                             for f in dataclasses.fields(skeleton)})


def _specs(leaves) -> list:
    return [(tuple(t.shape), t.dtype) for t in leaves]


def _header(skeleton, leaves, device) -> list:
    """An edge's structure and its tensors' (shape, dtype) specs as two
    tensors on ``device``: the length (int64) and the bytes (uint8)."""
    payload = torch.frombuffer(bytearray(pickle.dumps((skeleton, _specs(leaves)))),
                               dtype=torch.uint8).to(device)
    return [torch.tensor([payload.numel()], dtype=torch.int64, device=device), payload]


def _read_header(payload: torch.Tensor):
    return pickle.loads(payload.cpu().numpy().tobytes())


def _micro_batch(inputs, i: int):
    skeleton, leaves = _flatten(inputs)
    return _unflatten(skeleton, iter([t[i] for t in leaves]))


def _stack(outs: list):
    """Stage outputs stacked along a new leading axis, leaf by leaf."""
    flat = [_flatten(y) for y in outs]
    return _unflatten(flat[0][0], iter([torch.stack(ts) for ts in zip(*(f[1] for f in flat))]))


def pipeline_map(stage_fns, inputs, group: Group | None):
    """Run ``stage_fns[0] -> ... -> stage_fns[S-1]`` over micro-batches,
    stage s on rank s.

    stage_fns: S functions; stage 0 takes one micro-batch of ``inputs``
      (every tensor indexed at i), stage s the output of stage s - 1.
      Outputs keep their dtypes and shapes from one micro-batch to the next.
    inputs: tensors (or tuples, lists, dataclasses of them) with a leading
      micro-batch axis M, the same on every rank; only rank 0 reads them.
    group: exactly S ranks (None counts as one).

    Returns the stacked final-stage outputs with leading axis M, on every
    rank, equal to ``stack([chain(inputs[i]) for i in range(M)])``."""
    S = len(stage_fns)
    size = 1 if group is None else group.size
    if size != S:
        raise ValueError(f"pipeline needs group size == n_stages ({S}), got {size}")
    n_micro = _flatten(inputs)[1][0].shape[0]
    if group is None:
        outs = []
        for i in range(n_micro):
            y = _micro_batch(inputs, i)
            for fn in stage_fns:
                y = fn(y)
            outs.append(y)
        return _stack(outs)

    s, last = group.rank, S - 1
    outs, pending, received, sent_specs = [], [], None, None
    for i in range(n_micro):
        if s == 0:
            x = _micro_batch(inputs, i)
        else:
            if received is None:       # the header comes before the first micro-batch
                (n,) = recv_prev(group, [((1,), torch.int64)])
                (payload,) = recv_prev(group, [((int(n[0]),), torch.uint8)])
                received = _read_header(payload)
            x = _unflatten(received[0], iter(recv_prev(group, received[1])))
        y = stage_fns[s](x)
        if s == last:
            outs.append(y)
            continue
        skeleton, leaves = _flatten(y)
        wait(group, pending)           # the previous micro-batch has left
        pending = []
        if sent_specs is None:
            sent_specs = _specs(leaves)
            pending += send_next(group, _header(skeleton, leaves, group.device))
        elif _specs(leaves) != sent_specs:
            raise ValueError(f"stage {s}'s output changed its shapes or dtypes at "
                             f"micro-batch {i}")
        pending += send_next(group, leaves)
    wait(group, pending)

    # the results live on the last rank: broadcast them to every rank
    leaves, header = None, None
    if s == last:
        skeleton, leaves = _flatten(_stack(outs))
        header = _header(skeleton, leaves, group.device)
    (n,) = broadcast_from(group, last, [((1,), torch.int64)], header and header[:1])
    (payload,) = broadcast_from(group, last, [((int(n[0]),), torch.uint8)],
                                header and header[1:])
    skeleton, specs = _read_header(payload)
    return _unflatten(skeleton, iter(broadcast_from(group, last, specs, leaves)))
