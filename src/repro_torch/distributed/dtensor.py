"""The model's pieces that DTensor would lay out unlike GSPMD, run on
DTensors as the plain code on each device's shard.

Used where the weights and the decode state are DTensors laid out by the
sharding specs (``sharding.distribute_model``) on a ``DeviceMesh``, the dry
run's fake mesh (``launch.mesh.fake_device_mesh``).  DTensor propagates the
projections, norms and losses op by op; where its rules would gather,
replicate or stall, the models hand the work here (``is_dtensor`` is one
look into ``sys.modules`` and one ``isinstance`` on tensors that are
plain, and imports nothing):

* ``gqa_attention``: the GQA reshape of head-sharded queries into
  [Hkv, G] groups has no DTensor layout when the KV heads do not divide
  the ``model`` axis (internlm2's 8 over 16), and DTensor would gather the
  queries on every device.  Here each device takes its batch rows and its
  query heads and the KV heads those read, runs the plain attention on
  them, and the KV heads' gradients go back as partial sums.  The math
  is the plain code's, shard by shard, as GSPMD shards the reference's
  einsums.
* ``decode_attention``: the cache keeps its own layout.  Batch rows and
  KV heads split as the cache does; a cache split along its rows (split-KV,
  ``state_specs``) gives each device the attention over its own rows, one
  ``decode_attn`` op counted over them, merged across the axis by its log
  sum of weights (``decode_attn.cu``'s own split-KV spans, cut across
  devices; three small all-reduces, where GSPMD reduces the softmax's max,
  sum and P.V over the rows).
* ``moe_ffn``: the capacity dispatch's one-hot tensors [T, E, C] take
  DTensor layouts that split C unevenly; here each device routes its own
  tokens to its own experts (expert parallel over ``model`` where E
  divides it, else each expert's F split there), the capacity and each
  token's slot those of the whole batch (the experts every token chose
  are gathered, a few bytes a token), the experts' buffers summed over
  the batch's split and cut along their slots there, and the output goes
  back as a partial sum over ``model``: the reference's dispatch, drops
  and all.
* ``wkv``: RWKV's chunkwise recurrence, a Python loop of ~20 ops a
  chunk, run on each device's batch rows and heads (no op of it mixes
  heads or rows).
* ``write_row``: the new token's K/V into the cache's slot on the device
  that holds that row.
* ``heads``: a projection's output split along whole heads on the
  ``model`` axis (or whole there), so that its reshape into heads keeps a
  layout; DTensor's matmul may split it across a head.
* ``embed``: the lookup of token ids in the embedding table split by
  vocabulary over ``model`` (Megatron's: each device looks up the ids in
  its rows, zeros the others, and the rows are summed across ``model``),
  where DTensor's rule for the index op weighs every layout of the table
  across a mesh of three axes (minutes a lookup).
* ``merge_heads``: attention's output [B, S, H, hd] merged into [B, S,
  H * hd] on each device, so that the gradient coming back from the
  output projection (split along H * hd as the row-parallel weight is)
  reaches the merge in its own layout: a view's backward cannot split a
  sharded H * hd into heads that do not divide the axis.
* ``residual``: the residual stream laid out as Megatron and GSPMD keep
  it, batch rows split over the data axes and whole on the ``model``
  axis; DTensor's lookup into a vocab-split embedding leaves it split
  along D, which no projection's layout then matches.
"""
from __future__ import annotations

import sys

import torch

__all__ = ["is_dtensor", "embed", "heads", "merge_heads", "residual",
           "gqa_attention", "decode_attention", "moe_ffn", "wkv",
           "write_row"]


def is_dtensor(x) -> bool:
    """Whether ``x`` is a DTensor (without importing DTensor's module)."""
    mod = sys.modules.get("torch.distributed.tensor")
    return mod is not None and isinstance(x, mod.DTensor)


def _dp_dims(mesh) -> list[int]:
    """The mesh dims that split the batch: all but ``model``."""
    return [i for i, n in enumerate(mesh.mesh_dim_names) if n != "model"]


def _batch_split(mesh, B: int) -> bool:
    n = 1
    for i in _dp_dims(mesh):
        n *= mesh.size(i)
    return B % n == 0 and B > 1


def _batch_rows(mesh, B: int) -> tuple[int, int]:
    """This device's rows of a batch of ``B`` split over the dp dims
    (major to minor), or all of them."""
    if not _batch_split(mesh, B):
        return 0, B
    idx, n = 0, 1
    for i in _dp_dims(mesh):
        idx = idx * mesh.size(i) + mesh.get_local_rank(i)
        n *= mesh.size(i)
    return idx * (B // n), (idx + 1) * (B // n)


def residual(x):
    """``x`` [B, ...] (a DTensor) with its batch rows split over the data
    axes where they divide, and whole on every other mesh axis; anything
    else as it is."""
    if not is_dtensor(x):
        return x
    from torch.distributed.tensor import Replicate, Shard

    mesh = x.device_mesh
    split = _batch_split(mesh, x.shape[0])
    pl = [Shard(0) if split and n != "model" else Replicate()
          for n in mesh.mesh_dim_names]
    return x.redistribute(mesh, pl)


def embed(table, ids):
    """``table[ids]``: plain tensors as they are; a DTensor ``table``
    [V, D] and ids [B, S] (a DTensor, or plain and whole) looked up on each
    device (see the module's docstring).  Returns the rows [B, S, D], a
    DTensor with the batch split as the ids are and partial over the
    axis the vocabulary is split on."""
    if not is_dtensor(table):
        return table[ids.long()]
    from torch.distributed.tensor import DTensor, Partial, Replicate, Shard

    mesh = table.device_mesh
    B = ids.shape[0]
    pi = [Shard(0) if _batch_split(mesh, B) and n != "model" else Replicate()
          for n in mesh.mesh_dim_names]
    if not is_dtensor(ids):
        ids = DTensor.from_local(ids, mesh, [Replicate()] * mesh.ndim,
                                 run_check=False)
    local = ids.redistribute(mesh, pi).to_local().long()
    rows = table.to_local()
    pout = list(pi)
    lo = 0
    for i, pl in enumerate(table.placements):
        if isinstance(pl, Shard) and pl.dim == 0:
            lo = mesh.get_local_rank(i) * rows.shape[0]
            pout[i] = Partial()
        elif not pl.is_replicate():
            rows = table.redistribute(mesh, [Replicate()] * mesh.ndim
                                      ).to_local()
            lo, pout = 0, list(pi)
            break
    idx = local - lo
    outside = (idx < 0) | (idx >= rows.shape[0])
    out = rows[idx.clamp(0, rows.shape[0] - 1)]
    out = out.masked_fill(outside[..., None], 0)
    return DTensor.from_local(out, mesh, pout, run_check=False,
                              shape=(*ids.shape, table.shape[1]),
                              stride=(ids.shape[1] * table.shape[1],
                                      table.shape[1], 1))


def heads(t, n_heads: int):
    """A projection ``t`` [B, S, H * hd] (a DTensor) with its batch rows
    as they are and its last axis split over ``model`` along whole heads
    when ``n_heads`` divides, else whole there; anything else as it is."""
    if not is_dtensor(t):
        return t
    from torch.distributed.tensor import Replicate, Shard

    mesh = t.device_mesh
    pl = []
    for i, n in enumerate(mesh.mesh_dim_names):
        if n != "model":
            pl.append(t.placements[i] if t.placements[i] == Shard(0)
                      else Replicate())
        elif n_heads % mesh.size(i) == 0:
            pl.append(Shard(t.dim() - 1))
        else:
            pl.append(Replicate())
    return t.redistribute(mesh, pl)


def merge_heads(o):
    """o [B, S, H, hd] as [B, S, H * hd]: a plain reshape, or, for a
    DTensor split along B or H, the same on each device's shard."""
    B, S, H, hd = o.shape
    if not is_dtensor(o) or any(
            not (p.is_replicate() or p.is_shard(0) or p.is_shard(2))
            for p in o.placements):
        return o.reshape(B, S, H * hd)
    local = o.to_local(grad_placements=o.placements)
    return _from_local(local.reshape(*local.shape[:2], -1), o.device_mesh,
                       o.placements, (B, S, H * hd))


def _from_local(t, mesh, pl, shape):
    """The local result ``t`` as a contiguous DTensor of global
    ``shape``."""
    from torch.distributed.tensor import DTensor

    stride, n = [], 1
    for d in reversed(shape):
        stride.append(n)
        n *= d
    return DTensor.from_local(t.contiguous(), mesh, pl, run_check=False,
                              shape=tuple(shape),
                              stride=tuple(reversed(stride)))


def gqa_attention(fn, q, k, v, **kw):
    """``fn`` (the plain ``models.attention.gqa_attention``) on each
    device's shard: q [B, S, Hq, D], k/v [B, T, Hkv, D] DTensors; the
    output [B, S, Hq, D] a DTensor split as the queries."""
    from torch.distributed.tensor import Partial, Replicate, Shard

    mesh = q.device_mesh
    B, _, Hq, _ = q.shape
    Hkv = k.shape[2]
    G = Hq // Hkv
    bsplit = _batch_split(mesh, B)
    pq, pkv, gkv = [], [], []
    kv_heads = None
    for i, name in enumerate(mesh.mesh_dim_names):
        n = mesh.size(i)
        if name != "model":
            pl = Shard(0) if bsplit else Replicate()
            pq.append(pl), pkv.append(pl), gkv.append(pl)
            continue
        hl = Hq // n
        if Hq % n == 0 and Hkv % n == 0:
            pq.append(Shard(2)), pkv.append(Shard(2)), gkv.append(Shard(2))
        elif Hq % n == 0 and (G % hl == 0 or hl % G == 0):
            # whole query heads here; the KV heads they read, sliced out of
            # replicated K/V, whose gradients are partial sums
            j = mesh.get_local_rank(i)
            kv_heads = slice(j * hl // G, ((j + 1) * hl - 1) // G + 1)
            pq.append(Shard(2)), pkv.append(Replicate()), gkv.append(Partial())
        else:
            pq.append(Replicate()), pkv.append(Replicate())
            gkv.append(Replicate())
    ql = q.redistribute(mesh, pq).to_local()
    kl = k.redistribute(mesh, pkv).to_local(grad_placements=gkv)
    vl = v.redistribute(mesh, pkv).to_local(grad_placements=gkv)
    if kv_heads is not None:
        kl, vl = kl[:, :, kv_heads], vl[:, :, kv_heads]
    return _from_local(fn(ql, kl, vl, **kw), mesh, pq, q.shape)


def _partial(q, k, v, kv_len):
    """Attention of q [B, Hq, D] over its device's cache rows k/v [B, T,
    Hkv, D], row b over its first ``kv_len[b]`` of them: (the output
    normalised over those rows, float32 [B, Hq, D]; its log sum of
    weights [B, Hq], -inf where a row reads none)."""
    B, Hq, D = q.shape
    T, Hkv = k.shape[1], k.shape[2]
    qg = q.reshape(B, Hkv, Hq // Hkv, D).float()
    s = torch.einsum("bhgd,bshd->bhgs", qg, k.float()) * D ** -0.5
    mask = (torch.arange(T, device=q.device)[None, :]
            < kv_len.to(torch.int64)[:, None])[:, None, None, :]
    s = s.masked_fill(~mask, float("-inf"))
    lse = torch.logsumexp(s, dim=-1)
    p = torch.exp(s - torch.where(torch.isinf(lse), 0.0, lse)[..., None])
    out = torch.einsum("bhgs,bshd->bhgd", p, v.float())
    return out.reshape(B, Hq, D), lse.reshape(B, Hq)


def decode_attention(fn, q, k, v, kv_len, **kw):
    """``fn`` (``kernels.ops.decode_attn``) on each device's shard: q
    [B, Hq, D], the caches k/v [B, T, Hkv, D] DTensors in their own
    layout, ``kv_len`` int32 [B] (plain: the same on every device).  A
    cache split along its rows is merged across that axis (see the
    module's docstring).  Returns a DTensor [B, Hq, D]."""
    from torch.distributed import _functional_collectives as funcol
    from torch.distributed.tensor import Replicate, Shard

    from repro_torch.analysis import cost
    from repro_torch.kernels.decode_attn import work

    mesh = k.device_mesh
    pq, split = [], None
    for i, pl in enumerate(k.placements):
        if isinstance(pl, Shard) and pl.dim in (0, 2):
            pq.append(Shard(0 if pl.dim == 0 else 1))
        elif isinstance(pl, Shard) and pl.dim == 1:
            pq.append(Replicate())
            split = i
        elif pl.is_replicate():
            pq.append(Replicate())
        else:
            raise ValueError(f"cache placement {pl} on mesh dim {i}")
    ql = q.redistribute(mesh, pq).to_local()
    kl, vl = k.to_local(), v.to_local()
    lo, hi = _batch_rows(mesh, kv_len.shape[0]) if any(
        isinstance(pl, Shard) and pl.dim == 0 for pl in k.placements) else (
        0, kv_len.shape[0])
    lens = kv_len[lo:hi]
    if split is None:
        return _from_local(fn(ql, kl, vl, lens, **kw), mesh, pq, q.shape)
    rows = kl.shape[1]
    first = mesh.get_local_rank(split) * rows
    lens = (lens.to(torch.int64) - first).clamp(0, rows).to(torch.int32)
    with cost.op("decode_attn", lambda: work(ql, kl, lens)):
        out, lse = _partial(ql, kl, vl, lens)
    group = (mesh, split)
    m = funcol.all_reduce(lse, "max", group)
    w = torch.exp(lse - torch.where(torch.isinf(m), 0.0, m))
    num = funcol.all_reduce(out * w[..., None], "sum", group)
    den = funcol.all_reduce(w, "sum", group)
    out = (num / den.clamp_min(1e-30)[..., None]).to(q.dtype)
    return _from_local(out, mesh, pq, q.shape)


def moe_ffn(x, params, *, top_k: int, capacity_factor: float, impl: str):
    """``models.moe.moe_ffn`` on each device's tokens and experts, with the
    whole batch's capacity and slots: x [B, S, D] and the weights
    DTensors.  Returns (y [B, S, D] a DTensor, aux this device's)."""
    from torch.distributed.tensor import DTensor, Partial, Replicate, Shard

    from repro_torch.models import moe

    mesh = x.device_mesh
    x = residual(x)
    whole = [Replicate()] * mesh.ndim
    router = params["router"].redistribute(mesh, whole).to_local()
    E, F_ = router.shape[1], params["wg"].shape[-1]
    m = mesh.mesh_dim_names.index("model")
    n, j = mesh.size(m), mesh.get_local_rank(m)

    def local(name, dim):
        pl = list(whole)
        if dim is not None:
            pl[m] = Shard(dim)
        return params[name].redistribute(mesh, pl).to_local()

    if impl != "onehot" or (E % n and F_ % n):
        # the whole batch and every expert here; this device's rows back
        w = {k: local(k, None) for k in ("wg", "wu", "wd")}
        y, aux = moe.moe_ffn(x.redistribute(mesh, whole).to_local(),
                             {"router": router, **w}, top_k=top_k,
                             capacity_factor=capacity_factor, impl=impl)
        lo, hi = _batch_rows(mesh, x.shape[0])
        return _from_local(y[lo:hi], mesh, x.placements, x.shape), aux
    ep = E % n == 0
    w = {"wg": local("wg", 0 if ep else 2), "wu": local("wu", 0 if ep else 2),
         "wd": local("wd", 0 if ep else 1)}
    xl = x.to_local()
    B, S, D = xl.shape
    xt = xl.reshape(B * S, D)
    probs, gates, experts = moe._route(xt.float() @ router.float(), top_k)
    # every token's experts, in the batch's order: each slot counts them
    every = DTensor.from_local(experts.reshape(B, S, top_k), mesh,
                               x.placements, run_check=False,
                               shape=(*x.shape[:2], top_k),
                               stride=(x.shape[1] * top_k, top_k, 1))
    every = every.redistribute(mesh, whole).to_local().reshape(-1, top_k)
    T = every.shape[0]
    capacity = max(int(T * top_k / E * capacity_factor), 1)
    first = _batch_rows(mesh, x.shape[0])[0] * S
    dispatch, combine = moe.dispatch_slots(every, gates, E, capacity, first)
    if ep:
        e = slice(j * E // n, (j + 1) * E // n)
        dispatch, combine = dispatch[:, e], combine[:, e]
    xe = torch.einsum("tec,td->ecd", dispatch.to(xl.dtype), xt)
    # the experts' buffers hold every device's tokens: summed over the
    # batch's split and cut along the slots there (padded to a whole
    # number of slots a device), run, and gathered back for the combine
    split = [i for i, p in enumerate(x.placements) if p == Shard(0)]
    ways = 1
    for i in split:
        ways *= mesh.size(i)
    pad = -capacity % ways
    xe = torch.nn.functional.pad(xe, (0, 0, 0, pad))
    base = [Shard(0) if ep and i == m else Replicate()
            for i in range(mesh.ndim)]
    summed = [Partial() if i in split else p for i, p in enumerate(base)]
    cut = [Shard(1) if i in split else p for i, p in enumerate(base)]
    shape = (E if ep else xe.shape[0], *xe.shape[1:])
    xe = _from_local(xe, mesh, summed, shape).redistribute(
        mesh, cut).to_local()
    ye = _from_local(moe._experts(xe, w), mesh, cut, shape).redistribute(
        mesh, base).to_local()[:, :capacity]
    y = torch.einsum("tec,ecd->td", combine.to(xl.dtype), ye)
    out_pl = list(x.placements)
    out_pl[m] = Partial()
    return DTensor.from_local(y.reshape(B, S, D), mesh, out_pl,
                              run_check=False, shape=x.shape,
                              stride=x.stride()), moe._aux(probs, experts)


def wkv(fn, r, k, v, logw, u, state, chunk: int):
    """``fn`` (``models.rwkv._wkv``) on each device's batch rows and
    heads: r, k, v, logw [B, S, H, K] and u [H, K] DTensors, the state
    [B, H, K, K] a DTensor or None.  Returns (o, the last state) as
    DTensors."""
    from torch.distributed.tensor import Replicate, Shard

    mesh = r.device_mesh
    B, S, H, K = r.shape
    bsplit = _batch_split(mesh, B)
    p4, pu, ps = [], [], []
    for i, name in enumerate(mesh.mesh_dim_names):
        if name != "model":
            b = Shard(0) if bsplit else Replicate()
            p4.append(b), pu.append(Replicate()), ps.append(b)
        elif H % mesh.size(i) == 0:
            p4.append(Shard(2)), pu.append(Shard(0)), ps.append(Shard(1))
        else:
            p4.append(Replicate()), pu.append(Replicate())
            ps.append(Replicate())
    loc = [t.redistribute(mesh, p4).to_local() for t in (r, k, v, logw)]
    sl = None if state is None else state.redistribute(mesh, ps).to_local()
    o, s = fn(*loc, u.redistribute(mesh, pu).to_local(), sl, chunk)
    return (_from_local(o, mesh, p4, (B, S, H, K)),
            _from_local(s, mesh, ps, (B, H, K, K)))


def write_row(cache, slot: int, row) -> None:
    """``cache[:, slot] = row`` for a DTensor cache [B, T, ...] (any
    layout) and its new row [B, ...]: the device holding row ``slot``
    writes its share; a device holding other rows writes nothing."""
    from torch.distributed.tensor import Replicate, Shard

    mesh = cache.device_mesh
    pl, lo = [], 0
    local = cache.to_local()
    for i, c in enumerate(cache.placements):
        if isinstance(c, Shard) and c.dim == 1:
            n = local.shape[1]
            if mesh.get_local_rank(i) != slot // n:
                return
            lo = (slot // n) * n
            pl.append(Replicate())
        elif isinstance(c, Shard):
            pl.append(Shard(c.dim - 1))
        else:
            pl.append(Replicate())
    local[:, slot - lo] = row.redistribute(mesh, pl).to_local()
