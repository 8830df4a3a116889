"""Sharding rules: param-tree paths -> partition specs over ("pod","data","model").

Port of ``src/repro/distributed/sharding.py``.  The layout is FSDP x TP
(+ EP for MoE):

* matmul weights shard their *input-feature* axis over ``data`` (ZeRO-3
  weight sharding) and their *output-feature* axis over ``model`` (Megatron
  tensor parallel); row-parallel weights ("wo", "wd", "cv", "w_out") are
  transposed in the rule.
* MoE expert stacks shard the expert axis over ``model`` when it divides
  evenly (expert parallelism: qwen3 128e/16); otherwise fall back to plain
  FSDP x TP on the (D, F) axes (grok 8e on a 16-way model axis).
* 1-D / small tensors (norms, biases, per-channel gates) replicate.
* ``pod`` is a pure data-parallel axis: batch shards over ("pod","data"),
  parameters are replicated across pods.

Rules are *name-driven* with shape-divisibility guards, so every arch in the
pool maps without per-arch tables, and a failed guard degrades to
replication instead of an error.

The port cannot import ``jax.sharding.PartitionSpec``: a spec is a plain
tuple, one entry per leading axis of its leaf, each entry an axis name,
``None`` (not sharded) or a tuple of two or more names, as
``PartitionSpec`` normalises it; ``P()`` is ``()``.  Spec trees
are nested dicts over the reference's tree, whose leaves stack each
family's layers on a leading axis (``LM.tree()``, the checkpoint), not over
the port's per-layer modules: the rules branch on a leaf's rank (the MoE
rule on ``[L, E, D, F]``).  ``stacked_shapes`` gives that tree as ``meta``
tensors, from the port's parameter names through ``tree_path``.

The port runs on one card.  ``check_specs`` holds a spec tree to its
leaves on a mesh; ``require_one_card`` refuses a mesh of more than one card
(ROADMAP.md Queue 1 item 12) instead of ignoring its specs, unless the mesh
is a torch ``DeviceMesh`` over a fake process group
(``launch.mesh.fake_device_mesh``): there the specs lay tensors out as
DTensors for the dry run.  ``placements`` turns a spec into DTensor
placements; ``distribute_model`` and ``distribute_named`` lay the port's
per-layer tensors out by the stacked tree's specs, ``distribute`` one
stacked leaf.
"""
from __future__ import annotations

import torch

from repro_torch.launch.mesh import Mesh, make_mesh, mesh_chip_count
from repro_torch.models.common import ArchConfig

__all__ = ["param_specs", "opt_specs", "state_specs", "batch_spec", "dp_axes",
           "stacked_shapes", "tree_leaves", "shard_shape",
           "check_specs", "one_card_mesh", "require_one_card", "as_mesh",
           "placements", "distribute", "distribute_named",
           "distribute_model", "local_bytes"]

# weight name -> which logical axis gets "model": "col" shards the last axis,
# "row" shards the second-to-last.
_COL = {"wq", "wk", "wv", "wg", "wu", "xq", "xk", "xv", "ck", "cr",
        "w_gate", "w_in", "wr", "wa", "wi", "w_lora_a"}
_ROW = {"wo", "wd", "xo", "cv", "w_out", "w_lora_b"}


def dp_axes(multi_pod: bool):
    return ("pod", "data") if multi_pod else ("data",)


def _entry(axes: tuple[str, ...]):
    """A spec entry of ``axes``: one name alone, as ``PartitionSpec``
    keeps ``("data",)``."""
    return axes[0] if len(axes) == 1 else axes


def _divisible(n: int, mesh_shape: dict, axis: str) -> bool:
    return axis in mesh_shape and n % mesh_shape[axis] == 0


def _spec_for(path: tuple[str, ...], shape: tuple[int, ...], mesh_shape: dict,
              cfg: ArchConfig) -> tuple:
    name = path[-1]
    nd = len(shape)
    md = mesh_shape.get("model", 1)

    if name == "embed":  # [V, D] — vocab over model (Megatron embedding)
        if _divisible(shape[0], mesh_shape, "model"):
            return ("model", None)
        return (None, "model") if _divisible(shape[1], mesh_shape, "model") else ()
    if name == "head":   # [D, V]
        if _divisible(shape[1], mesh_shape, "model") and _divisible(shape[0], mesh_shape, "data"):
            return ("data", "model")
        return (None, "model") if _divisible(shape[1], mesh_shape, "model") else ()
    if name == "enc_pos":
        return ()

    # MoE expert stacks: [L, E, D, F] / [L, E, F, D]
    if name in ("wg", "wu", "wd") and nd == 4:
        E = shape[1]
        if _divisible(E, mesh_shape, "model"):
            # expert parallelism + FSDP on the wider matrix axis
            wide = 2 if shape[2] >= shape[3] else 3
            spec = [None, "model", None, None]
            if _divisible(shape[wide], mesh_shape, "data"):
                spec[wide] = "data"
            return tuple(spec)
        # fallback: FSDP x TP on (D, F)
        col = name in ("wg", "wu")
        d_ax, f_ax = (2, 3) if col else (3, 2)
        spec = [None, None, None, None]
        if _divisible(shape[d_ax], mesh_shape, "data"):
            spec[d_ax] = "data"
        if _divisible(shape[f_ax], mesh_shape, "model"):
            spec[f_ax] = "model"
        return tuple(spec)
    if name == "router":  # [L, D, E]
        return (None, "data", None) if _divisible(shape[1], mesh_shape, "data") else ()

    if name in _COL and nd >= 2:
        spec = [None] * nd
        model_ok = _divisible(shape[-1], mesh_shape, "model")
        if name in ("wk", "wv", "xk", "xv"):
            # KV projections: only shard when whole heads land on each
            # shard (sharding head_dim replicates the attention logits)
            model_ok = model_ok and cfg.n_kv % max(md, 1) == 0
        if model_ok:
            spec[-1] = "model"
        if _divisible(shape[-2], mesh_shape, "data"):
            spec[-2] = "data"
        return tuple(spec)
    if name in _ROW and nd >= 2:
        spec = [None] * nd
        if _divisible(shape[-2], mesh_shape, "model"):
            spec[-2] = "model"
        if _divisible(shape[-1], mesh_shape, "data"):
            spec[-1] = "data"
        return tuple(spec)
    return ()  # norms, gates, biases, conv taps: replicated


# ------------------------------------------------------------- spec trees
def stacked_shapes(named) -> dict:
    """(name, tensor) pairs of the port's parameters (or of tensors keyed
    like them: the optimizer's moments) -> the JAX package's nested dict of
    leaves as ``meta`` tensors (no memory), each family's layers stacked on
    a leading axis as ``init_params`` lays them out."""
    from repro_torch.models.transformer import tree_path

    groups: dict[tuple, list] = {}
    for name, t in named:
        path, layer = tree_path(name)
        groups.setdefault(path, []).append((layer, t))
    tree: dict = {}
    for path, items in groups.items():
        layer, t = items[0]
        shape = tuple(t.shape) if layer is None else (len(items), *t.shape)
        node = tree
        for k in path[:-1]:
            node = node.setdefault(k, {})
        node[path[-1]] = torch.empty(shape, dtype=t.dtype, device="meta")
    return tree


def tree_leaves(tree, prefix: tuple = ()):
    """(key path, leaf) of every leaf of a nested dict, keys in sorted
    order (as ``jax.tree.leaves`` flattens a dict)."""
    if not isinstance(tree, dict):
        yield prefix, tree
        return
    for k in sorted(tree):
        yield from tree_leaves(tree[k], prefix + (k,))


def _map(fn, tree, prefix: tuple = ()):
    """The nested dict with each leaf replaced by ``fn(path, leaf)``."""
    if isinstance(tree, dict):
        return {k: _map(fn, v, prefix + (k,)) for k, v in tree.items()}
    return fn(prefix, tree)


def param_specs(cfg: ArchConfig, mesh) -> dict:
    """The spec tree of ``init_params_shape(cfg)``'s stacked leaves."""
    from repro_torch.models.transformer import init_params_shape

    mesh_shape = dict(zip(mesh.axis_names, mesh.devices.shape))
    shapes = stacked_shapes(init_params_shape(cfg).named_parameters())
    return _map(lambda path, leaf: _spec_for(path, tuple(leaf.shape),
                                             mesh_shape, cfg), shapes)


def opt_specs(pspecs) -> dict:
    """Optimizer moments shard exactly like their parameters."""
    return {"m": pspecs, "v": pspecs, "step": ()}


def batch_spec(multi_pod: bool, *, n_micro: bool = False) -> tuple:
    dp = _entry(dp_axes(multi_pod))
    return (None, dp, None) if n_micro else (dp, None)


def state_specs(cfg: ArchConfig, mesh, multi_pod: bool, *, batch: int = 8,
                cache_len: int = 16, split_kv: bool = True) -> dict:
    """Decode-state sharding: batch over dp axes, heads over model when even.

    Divisibility guards are evaluated on the *real* (batch, cache_len), so a
    batch-1 long-context cell degrades to replication instead of erroring.

    ``split_kv``: when the KV-head count does not divide the model axis,
    shard the cache *sequence* dimension over ``model`` instead
    (FlashDecoding-style split-KV).
    """
    from repro_torch.models.transformer import init_decode_state

    mesh_shape = dict(zip(mesh.axis_names, mesh.devices.shape))
    dp = dp_axes(multi_pod)
    dp_total = 1
    for a in dp:
        dp_total *= mesh_shape.get(a, 1)

    def spec(path, leaf):
        shape = leaf.shape
        nd = len(shape)
        # leading axis is the layer stack; batch is axis 1
        s = [None] * nd
        if nd >= 2 and shape[1] % dp_total == 0 and shape[1] > 1:
            s[1] = _entry(dp)
        # KV caches [L, B, T, Hkv, hd]: shard heads over model if divisible
        md = mesh_shape.get("model", 1)
        if nd == 5 and shape[3] % md == 0 and shape[3] > 1:
            s[3] = "model"
        elif nd == 5 and split_kv and shape[2] % md == 0 and shape[2] > md:
            s[2] = "model"  # split-KV: shard the cache sequence dim
        # RWKV state [L, B, H, K, K] (the reference tests "S" in
        # str(DictKey), "['S']": the same answer on the plain key)
        if nd == 5 and path and "S" in path[-1] and shape[2] % mesh_shape.get("model", 1) == 0:
            s[2] = "model"
            s[3] = None
        return tuple(s)

    shapes = init_decode_state(cfg, batch, cache_len, device="meta")
    return _map(spec, shapes)


# ------------------------------------------------------- specs on a mesh
def _axes(entry) -> tuple[str, ...]:
    """The mesh axes one spec entry names (none for ``None``)."""
    if entry is None:
        return ()
    return entry if isinstance(entry, tuple) else (entry,)


def as_mesh(mesh) -> Mesh:
    """The port's mesh description of ``mesh``: itself, or a torch
    ``DeviceMesh``'s shape and axis names."""
    if isinstance(mesh, Mesh):
        return mesh
    names = getattr(mesh, "mesh_dim_names", None)
    if names is None:
        return mesh        # anything with axis_names and devices
    return make_mesh(tuple(mesh.shape), tuple(names))


def shard_shape(shape, spec, mesh) -> tuple[int, ...]:
    """One card's shard of a leaf of ``shape``: each axis divided by the
    sizes of the mesh axes its spec entry names (``check_specs`` first)."""
    mesh = as_mesh(mesh)
    sizes = dict(zip(mesh.axis_names, mesh.devices.shape))
    out = list(shape)
    for i, entry in enumerate(spec):
        for a in _axes(entry):
            out[i] //= sizes[a]
    return tuple(out)


def check_specs(tree, specs, mesh, what: str = "") -> None:
    """Raise ``ValueError``, naming the leaf, unless ``specs`` has a spec
    for every leaf of ``tree`` (tensors, or anything with a ``shape``) and
    each spec fits its leaf on ``mesh``: no more entries than the leaf has
    axes, only the mesh's axis names, no axis twice, and every axis divided
    by the sizes of the mesh axes named for it."""
    mesh = as_mesh(mesh)
    sizes = dict(zip(mesh.axis_names, mesh.devices.shape))
    spec_of = dict(tree_leaves(specs))
    for path, leaf in tree_leaves(tree):
        name = "/".join(map(str, path))
        where = f"{what} leaf {name}" if what else f"leaf {name}"
        if path not in spec_of:
            raise ValueError(f"{where}: no spec")
        spec, shape = spec_of[path], tuple(leaf.shape)
        if not isinstance(spec, tuple) or len(spec) > len(shape):
            raise ValueError(f"{where}: spec {spec!r} does not fit a leaf of "
                             f"shape {shape}")
        used = [a for e in spec for a in _axes(e)]
        for a in used:
            if a not in sizes:
                raise ValueError(f"{where}: spec {spec} names {a!r}, not an "
                                 f"axis of the mesh {tuple(sizes)}")
        if len(set(used)) != len(used):
            raise ValueError(f"{where}: spec {spec} names an axis twice")
        for dim, entry in zip(shape, spec):
            n = 1
            for a in _axes(entry):
                n *= sizes[a]
            if dim % n:
                raise ValueError(f"{where}: spec {spec} splits an axis of "
                                 f"{dim} {n} ways (shape {shape}, mesh "
                                 f"{sizes})")


def one_card_mesh() -> Mesh:
    """The mesh of the card the port runs on: the reference's axes, each of
    size 1."""
    return make_mesh((1, 1), ("data", "model"))


def require_one_card(mesh, what: str) -> None:
    """Raise ``NotImplementedError`` for a mesh of more than one card: the
    port lays no tensor out across real cards (ROADMAP.md Queue 1 item
    12); on one card a spec's sharding constraint is the identity.  A
    ``DeviceMesh`` over a fake process group passes: its DTensors run one
    device's share of the work, with no data moved."""
    from repro_torch.launch.mesh import is_fake_mesh

    if not isinstance(mesh, Mesh) and hasattr(mesh, "mesh_dim_names") and \
            is_fake_mesh(mesh):
        return
    mesh = as_mesh(mesh)
    n = mesh_chip_count(mesh)
    if n > 1:
        raise NotImplementedError(
            f"{what} on a mesh of {n} cards {dict(zip(mesh.axis_names, mesh.devices.shape))}: "
            "the port runs on one card (ROADMAP.md Queue 1 item 12, "
            "multi-card layouts)")


# ------------------------------------------------------------- DTensors
def placements(spec: tuple, mesh) -> list:
    """DTensor placements of a leaf with ``spec`` on ``mesh`` (a torch
    ``DeviceMesh`` or the port's ``Mesh``): ``Shard(i)`` on each mesh axis
    the spec names for tensor axis i, ``Replicate()`` on the others.  An
    entry of two axes shards one tensor axis over both mesh axes, the first
    named the major, as the reference's ``PartitionSpec`` does; they must
    come in the mesh's order."""
    from torch.distributed.tensor import Replicate, Shard

    names = list(as_mesh(mesh).axis_names)
    out = [Replicate() for _ in names]
    for i, entry in enumerate(spec):
        axes = _axes(entry)
        idx = [names.index(a) for a in axes]
        if idx != sorted(idx):
            raise ValueError(f"spec entry {entry!r} names mesh axes out of "
                             f"the mesh's order {tuple(names)}")
        for j in idx:
            out[j] = Shard(i)
    return out


def distribute(t: torch.Tensor, spec: tuple, device_mesh):
    """``t`` (the whole tensor on this process) as a DTensor laid out by
    ``spec`` on ``device_mesh``: this rank keeps its own shard, and no
    data moves."""
    from torch.distributed.tensor import distribute_tensor

    return distribute_tensor(t.detach(), device_mesh,
                             placements(spec, device_mesh),
                             src_data_rank=None)


def _layer_spec(name: str, spec_of: dict) -> tuple:
    """The spec of one layer's tensor ``name`` (a parameter's name in the
    port) from its stacked leaf's spec, whose leading layer axis must not
    be split."""
    from repro_torch.models.transformer import tree_path

    path, layer = tree_path(name)
    if path not in spec_of:
        raise ValueError(f"{name}: no spec for leaf {'/'.join(path)}")
    spec = spec_of[path]
    if layer is None:
        return spec
    if spec and spec[0] is not None:
        raise ValueError(f"{name}: spec {spec} splits the stacked layer "
                         "axis of its leaf")
    return tuple(spec[1:])


def distribute_named(named: dict, specs: dict, device_mesh) -> dict:
    """name -> DTensor of tensors keyed like the port's parameters (the
    optimizer's moments), each laid out by its stacked leaf's spec."""
    spec_of = dict(tree_leaves(specs))
    return {n: distribute(t, _layer_spec(n, spec_of), device_mesh)
            for n, t in named.items()}


def distribute_model(model, specs: dict, device_mesh):
    """Lay the port's per-layer parameters out by the stacked tree's
    ``specs`` (``param_specs``) on ``device_mesh``, in place: each
    parameter becomes a DTensor parameter holding this rank's shard
    (``requires_grad`` kept).  Returns the model."""
    check_specs(stacked_shapes(model.named_parameters()), specs,
                device_mesh, "params")
    spec_of = dict(tree_leaves(specs))
    for name, p in list(model.named_parameters()):
        owner, _, leaf = name.rpartition(".")
        mod = model.get_submodule(owner) if owner else model
        dt = distribute(p, _layer_spec(name, spec_of), device_mesh)
        setattr(mod, leaf, torch.nn.Parameter(
            dt, requires_grad=p.requires_grad))
    return model


def local_bytes(tensors) -> int:
    """Bytes of this rank's shards of ``tensors`` (an iterable of tensors
    and DTensors)."""
    total = 0
    for t in tensors:
        local = getattr(t, "_local_tensor", t)
        total += local.numel() * local.element_size()
    return total
