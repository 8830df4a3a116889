"""The ACORN data plane engine: reprogram at runtime by rewriting tables.

Port of ``src/repro/core/plane.py`` (paper §6).  A physical switch compiles
its template P4 program once; every model (re)deployment afterwards only
rewrites match-action entries.  Here table entries are tensors of a
``PackedProgram``, and installing or swapping a model is a tensor update;
classify is one CUDA kernel launch plus plain torch glue (or, in the staged
modes, three launches or L + 2).

One engine hosts both pipelines (paper Fig. 5) — the tree pipeline (walk ->
dt_predict -> multitree_voting) and the SVM pipeline (svm_mul partials ->
native adds -> svm_predict) — and each packet selects its result by MID.
Non-request packets pass through untouched: their rslt *and* their
codes/svm_acc intermediates come out bit-identical.

Model zoo (the VID axis, paper Appendix A): every table carries a leading
version axis ``V = profile.max_versions``, each packet selects its tables by
``(MID, VID)``, and a packet addressing an empty or out-of-range slot gets
``rslt == -1``.

Install-time compilation (the exec image): program state splits into
**source tables** (what ``install_program`` writes) and a derived
``ExecImage`` — the kernel's operands (``kernels/tiling.py``).  Install and
evict prep only the written slot's image and splice it in.  Both return a
new ``PackedProgram`` and never write a tensor of the old one, which stays
valid; tensors the write does not touch are shared between the two.

A captured CUDA graph reads fixed addresses, so the executors that replay
one (``runtime/graphs.py``) hold a **resident** program instead
(``resident_program``): tensors of their own, written in place by
``install_program_``, ``evict_program_`` and ``copy_program_``, slot by
slot with ``copy_``, so no ``data_ptr`` ever moves.
"""
from __future__ import annotations

import dataclasses
import functools

import numpy as np
import torch

from repro_torch.core.packets import PacketBatch, PacketType, u32_bits
from repro_torch.core.translator import MID_SVM, TableProgram
from repro_torch.kernels import ops, tiling

__all__ = [
    "PlaneProfile",
    "PackedProgram",
    "ExecImage",
    "SwitchEngine",
    "build_exec_image",
    "empty_program",
    "install_program",
    "evict_program",
    "install_program_",
    "evict_program_",
    "resident_program",
    "copy_program_",
    "program_tensors",
    "packed_from_arrays",
    "DEFAULT_DEVICE",
]

_SENTINEL = np.uint32(0xFFFFFFFF)


# Entry points run on the card unless the caller asks for the CPU.
DEFAULT_DEVICE = torch.device("cuda")


@dataclasses.dataclass(frozen=True)
class PlaneProfile:
    """Fixed template shapes — the operator's compile-time knobs (paper §3.2:
    "the size of the data part is decided by the maximum number of supported
    features, which can be configured by the network operator")."""

    max_features: int = 60       # paper: up to 60 features
    feature_width: int = 8       # quantization bits
    max_trees: int = 8
    max_layers: int = 32         # paper: tree depth up to 32
    max_entries_per_layer: int = 128   # 2 * nodes per layer
    max_leaves: int = 256        # dt_predict entries per tree
    max_classes: int = 32
    max_hyperplanes: int = 12    # svm_predict direct table = 2^H entries
    levels: int = 256
    # Model-zoo slots per pipeline (the VID range).
    max_versions: int = 1

    def __post_init__(self):
        if self.max_hyperplanes > 16:
            raise ValueError("svm_predict direct table capped at 2^16 entries")
        if self.max_layers > 32:
            raise ValueError("status code is 32-bit (paper: 16-32 bit bitstring)")
        if self.max_versions < 1:
            raise ValueError("need at least one model-zoo version slot")
        if self.feature_width > 15:
            raise ValueError(
                "feature values are int16 in the fused-classify operand "
                "layout: feature_width must be <= 15")


@dataclasses.dataclass
class ExecImage:
    """Derived kernel operands — the installed *executable*.

    A pure function of the ``PackedProgram`` source tables
    (``build_exec_image``), kept in sync per slot by install and evict.
    ``fused`` is the operand group of every classify mode: the fused kernel
    reads all of it, the staged kernels its ``walk``, ``leaves`` and
    ``svm`` parts.  Its bias block is
    **zeros**: ``_classify_impl`` adds ``svm_bias`` outside the kernel so
    partial sums compose across devices (bias once, on the owning device).
    """

    fused: tiling.ClassifyFusedOperands


@dataclasses.dataclass
class PackedProgram:
    """Entry tensors for one engine — the runtime-swappable 'flow table'
    state.  Every table carries a leading version axis V; uint32 tables are
    int32 bit patterns (``core/packets.py``)."""

    # tree pipeline
    dt_cv: torch.Tensor       # int32 [V, L, T, E] (uint32 bits)
    dt_cm: torch.Tensor       # int32 [V, L, T, E] (uint32 bits)
    dt_fid: torch.Tensor      # int32 [V, L, T, E]
    dt_flo: torch.Tensor      # int32 [V, L, T, E]
    dt_fhi: torch.Tensor      # int32 [V, L, T, E]
    dt_bit: torch.Tensor      # int32 [V, L, T, E] {0, 1}
    dt_valid: torch.Tensor    # bool [V, L, T, E]
    layer_shift: torch.Tensor  # int32 [L] status-code bit per layer (shared)
    pred_codes: torch.Tensor  # int32 [V, T, P] sorted per (v, t) (uint32 bits)
    pred_labels: torch.Tensor  # int32 [V, T, P]
    pred_valid: torch.Tensor  # bool [V, T, P]
    pred_enable: torch.Tensor  # bool [V] — this device owns v's dt_predict
    vote_weights: torch.Tensor  # float32 [V, T]
    # svm pipeline
    svm_lut: torch.Tensor     # int32 [V, H, F, levels]
    svm_bias: torch.Tensor    # int32 [V, H]
    svm_hvalid: torch.Tensor  # bool [V, H]
    svm_pred_table: torch.Tensor  # int32 [V, 2^H]
    svm_pred_enable: torch.Tensor  # bool [V]
    # derived exec image — kernel operands, rebuilt per slot write
    image: ExecImage | None = None

    @property
    def n_versions(self) -> int:
        return self.pred_enable.shape[0]

    @property
    def device(self) -> torch.device:
        return self.dt_cv.device


_TREE_FIELDS = ("dt_cv", "dt_cm", "dt_fid", "dt_flo", "dt_fhi", "dt_bit",
               "dt_valid", "pred_codes", "pred_labels", "pred_valid",
               "pred_enable", "vote_weights")
_SVM_FIELDS = ("svm_lut", "svm_bias", "svm_hvalid", "svm_pred_table",
              "svm_pred_enable")
_U32_TABLES = ("dt_cv", "dt_cm", "pred_codes")
_BOOL_TABLES = ("dt_valid", "pred_valid", "pred_enable", "svm_hvalid",
                "svm_pred_enable")


def _fused_operands(packed: PackedProgram, s=slice(None)):
    """The kernel operands of the slots ``s`` (zero bias by design)."""
    return tiling.prep_classify_fused(
        packed.dt_cv[s], packed.dt_cm[s], packed.dt_fid[s], packed.dt_flo[s],
        packed.dt_fhi[s], packed.dt_bit[s], packed.dt_valid[s],
        packed.pred_codes[s], packed.pred_labels[s], packed.pred_valid[s],
        packed.vote_weights[s], packed.svm_lut[s],
        torch.zeros_like(packed.svm_bias[s]))


def build_exec_image(packed: PackedProgram) -> ExecImage:
    """Full (all-slot) source tables -> exec image.  Install and evict use
    the per-slot path instead; this is the from-scratch build."""
    return ExecImage(fused=_fused_operands(packed))


def _with_slot(full: torch.Tensor, vid: int, value) -> torch.Tensor:
    """A copy of ``full`` with slot ``vid`` replaced (the old tensor stays)."""
    out = full.clone()
    out[vid] = value
    return out


def _splice_slot(packed_new: PackedProgram, image: ExecImage | None,
                 vid: int) -> PackedProgram:
    """Re-prep slot ``vid`` of the fused group from the new source tables and
    splice it into a copy of the resident image."""
    if image is None:  # legacy program: recover with a full build
        return dataclasses.replace(packed_new,
                                   image=build_exec_image(packed_new))
    slot = _fused_operands(packed_new, slice(vid, vid + 1))
    fused = tiling.ClassifyFusedOperands(
        *(_with_slot(full, vid, s[0]) for full, s in zip(image.fused, slot)))
    return dataclasses.replace(packed_new, image=ExecImage(fused=fused))


def empty_program(profile: PlaneProfile, device=None) -> PackedProgram:
    device = torch.device(DEFAULT_DEVICE if device is None else device)
    V = profile.max_versions
    L, T, E = profile.max_layers, profile.max_trees, profile.max_entries_per_layer
    P, H, F = profile.max_leaves, profile.max_hyperplanes, profile.max_features
    i32 = dict(dtype=torch.int32, device=device)
    bool_ = dict(dtype=torch.bool, device=device)
    packed = PackedProgram(
        dt_cv=torch.zeros((V, L, T, E), **i32),
        dt_cm=torch.full((V, L, T, E), -1, **i32),     # 0xFFFFFFFF
        dt_fid=torch.zeros((V, L, T, E), **i32),
        dt_flo=torch.ones((V, L, T, E), **i32),
        dt_fhi=torch.zeros((V, L, T, E), **i32),
        dt_bit=torch.zeros((V, L, T, E), **i32),
        dt_valid=torch.zeros((V, L, T, E), **bool_),
        layer_shift=torch.arange(L, **i32),
        pred_codes=torch.full((V, T, P), -1, **i32),   # 0xFFFFFFFF
        pred_labels=torch.zeros((V, T, P), **i32),
        pred_valid=torch.zeros((V, T, P), **bool_),
        pred_enable=torch.zeros((V,), **bool_),
        vote_weights=torch.zeros((V, T), dtype=torch.float32, device=device),
        svm_lut=torch.zeros((V, H, F, profile.levels), **i32),
        svm_bias=torch.zeros((V, H), **i32),
        svm_hvalid=torch.zeros((V, H), **bool_),
        svm_pred_table=torch.zeros((V, 2**H), **i32),
        svm_pred_enable=torch.zeros((V,), **bool_),
    )
    return dataclasses.replace(packed, image=build_exec_image(packed))


def _check_vid(vid: int, profile: PlaneProfile) -> int:
    if not 0 <= vid < profile.max_versions:
        raise ValueError(
            f"vid {vid} out of range: profile hosts {profile.max_versions} "
            f"model-zoo versions (0..{profile.max_versions - 1})"
        )
    return vid


def _tensor(a: np.ndarray, device) -> torch.Tensor:
    """Host table -> device tensor, uint32 as int32 bits."""
    if a.dtype == np.uint32:
        return u32_bits(a).to(device)
    return torch.from_numpy(np.array(a)).to(device)


def _program_slot(program: TableProgram, profile: PlaneProfile,
                  stages: set[int] | None, vid: int | None
                  ) -> tuple[int, dict]:
    """One slot's source tables for ``program`` (host arrays keyed by field
    name), and the slot they go to."""
    vid = _check_vid(program.vid if vid is None else vid, profile)
    specs = program.stages()
    if stages is None:
        stages = set(range(len(specs)))
    own = [specs[i] for i in sorted(stages)]

    if program.kind in ("dt", "rf"):
        L, T, E = profile.max_layers, profile.max_trees, profile.max_entries_per_layer
        P = profile.max_leaves
        if program.n_trees > T:
            raise ValueError(f"{program.n_trees} trees > profile max {T}")
        cv = np.zeros((L, T, E), np.uint32)
        cm = np.full((L, T, E), _SENTINEL, np.uint32)
        fid = np.zeros((L, T, E), np.int32)
        flo = np.ones((L, T, E), np.int32)
        fhi = np.zeros((L, T, E), np.int32)
        bit = np.zeros((L, T, E), np.int32)
        valid = np.zeros((L, T, E), bool)
        owned_pairs = {
            (tab.tree, tab.layer) for s in own for tab in s.tables if tab.kind == "dt_layer"
        }
        for t, layers in enumerate(program.dt_layers):
            for lt in layers:
                if (t, lt.layer) not in owned_pairs:
                    continue
                n = lt.n_entries
                if lt.layer >= L:
                    raise ValueError(f"layer {lt.layer} > profile max {L}")
                if n > E:
                    raise ValueError(f"{n} entries at layer {lt.layer} > profile max {E}")
                cv[lt.layer, t, :n] = lt.code_value
                cm[lt.layer, t, :n] = lt.code_mask
                fid[lt.layer, t, :n] = lt.fid
                flo[lt.layer, t, :n] = lt.f_lo
                fhi[lt.layer, t, :n] = lt.f_hi
                bit[lt.layer, t, :n] = lt.set_bit
                valid[lt.layer, t, :n] = True
        own_predict = any(tab.kind == "dt_predict" for s in own for tab in s.tables)
        pc = np.full((T, P), _SENTINEL, np.uint32)
        pl_ = np.zeros((T, P), np.int32)
        pv = np.zeros((T, P), bool)
        w = np.zeros((T,), np.float32)
        if own_predict:
            for p in program.dt_predicts:
                n = p.n_entries
                if n > P:
                    raise ValueError(f"{n} leaves > profile max {P}")
                pc[p.tree, :n] = p.codes
                pl_[p.tree, :n] = p.labels
                pv[p.tree, :n] = True
            if program.voting is not None:
                w[: program.n_trees] = program.voting.weights
            else:
                w[0] = 1.0
        slots = dict(dt_cv=cv, dt_cm=cm, dt_fid=fid, dt_flo=flo, dt_fhi=fhi,
                     dt_bit=bit, dt_valid=valid, pred_codes=pc,
                     pred_labels=pl_, pred_valid=pv,
                     pred_enable=np.asarray(own_predict), vote_weights=w)
    elif program.kind == "svm":
        H, F, Lev = profile.max_hyperplanes, profile.max_features, profile.levels
        if program.n_hyperplanes > H:
            raise ValueError(f"{program.n_hyperplanes} hyperplanes > profile max {H}")
        if program.n_features > F:
            raise ValueError(f"{program.n_features} features > profile max {F}")
        lut = np.zeros((H, F, Lev), np.int32)
        # Ownership by stage (matches TableProgram.stages()/svm_stage_muls()).
        stage_muls = program.svm_stage_muls()
        owned_flat = set()
        for si in sorted(stages):
            if si < len(stage_muls):
                owned_flat.update(stage_muls[si])
        for k in owned_flat:
            m = program.svm_muls[k]
            lut[m.hyperplane, m.feature, : m.n_entries] = m.lut
        own_pred = any(tab.kind == "svm_predict" for s in own for tab in s.tables)
        bias = np.zeros((H,), np.int32)
        tbl = np.zeros((2**H,), np.int32)
        if own_pred:
            bias[: program.n_hyperplanes] = program.svm_bias
            sp = program.svm_predict
            if sp.table is None:
                raise ValueError("svm_predict table too large for direct materialization")
            tbl[: sp.table.shape[0]] = sp.table
        hvalid = np.zeros((H,), bool)
        hvalid[: program.n_hyperplanes] = True
        slots = dict(svm_lut=lut, svm_bias=bias, svm_hvalid=hvalid,
                     svm_pred_table=tbl, svm_pred_enable=np.asarray(own_pred))
    else:
        raise ValueError(f"unknown program kind {program.kind}")
    return vid, slots


def install_program(
    packed: PackedProgram,
    program: TableProgram,
    profile: PlaneProfile,
    *,
    stages: set[int] | None = None,
    vid: int | None = None,
) -> PackedProgram:
    """Write a TableProgram's entries into one model-zoo version slot (the
    control plane's 'update the entries in predefined tables', paper §6.2).

    ``vid`` selects the slot (default: the program's own ``vid``); every other
    slot — and the *other* pipeline's state — is preserved.  ``stages``
    restricts installation to a subset of program stages (the planner's
    per-device assignment); ``None`` installs everything.
    """
    vid, slots = _program_slot(program, profile, stages, vid)
    dev = packed.device
    new = dataclasses.replace(packed, **{
        name: _with_slot(getattr(packed, name), vid, _tensor(a, dev))
        for name, a in slots.items()})
    return _splice_slot(new, packed.image, vid)


def install_program_(
    packed: PackedProgram,
    program: TableProgram,
    profile: PlaneProfile,
    *,
    stages: set[int] | None = None,
    vid: int | None = None,
) -> PackedProgram:
    """``install_program`` written in place into ``packed``'s own tensors
    (a resident program): the same tables, no ``data_ptr`` moved.  Returns
    ``packed``."""
    vid, slots = _program_slot(program, profile, stages, vid)
    dev = packed.device
    _write_slot_(packed, vid, {name: _tensor(a, dev)
                               for name, a in slots.items()})
    return packed


@functools.lru_cache(maxsize=8)
def _blank_slot(profile: PlaneProfile) -> PackedProgram:
    """One blank (V=1) slot on the CPU, memoized per profile: the empty fills
    live only in ``empty_program``."""
    return empty_program(dataclasses.replace(profile, max_versions=1), "cpu")


def evict_program(
    packed: PackedProgram,
    profile: PlaneProfile,
    *,
    vid: int,
    kind: str = "all",
) -> PackedProgram:
    """Empty one model-zoo version slot (``kind``: "tree" | "svm" | "all").
    Packets addressing an evicted slot get ``rslt == -1`` — same as a slot
    that was never installed."""
    vid, blank = _blank_fields(profile, vid, kind, packed.device)
    new = dataclasses.replace(packed, **{
        f: _with_slot(getattr(packed, f), vid, b) for f, b in blank.items()})
    # The fused group spans both pipelines: rebuild its slot from the slot's
    # post-evict source tables.
    return _splice_slot(new, packed.image, vid)


def evict_program_(packed: PackedProgram, profile: PlaneProfile, *,
                   vid: int, kind: str = "all") -> PackedProgram:
    """``evict_program`` written in place into ``packed``'s own tensors (a
    resident program).  Returns ``packed``."""
    vid, blank = _blank_fields(profile, vid, kind, packed.device)
    _write_slot_(packed, vid, blank)
    return packed


def _blank_fields(profile: PlaneProfile, vid: int, kind: str, device
                  ) -> tuple[int, dict]:
    """The blank slot tables an evict of ``kind`` writes, on ``device``."""
    vid = _check_vid(vid, profile)
    if kind not in ("tree", "svm", "all"):
        raise ValueError(f"unknown evict kind {kind!r}")
    blank = _blank_slot(profile)
    fields = (_TREE_FIELDS if kind == "tree"
              else _SVM_FIELDS if kind == "svm"
              else _TREE_FIELDS + _SVM_FIELDS)
    return vid, {f: getattr(blank, f)[0].to(device) for f in fields}


def _write_slot_(packed: PackedProgram, vid: int, values: dict) -> None:
    """Copy one slot's source tables into ``packed`` and re-prep that slot
    of its exec image, every write a ``copy_`` into the tensors it has."""
    if packed.image is None:
        raise ValueError("a program written in place must carry its exec "
                         "image (resident_program builds it)")
    for name, value in values.items():
        getattr(packed, name)[vid].copy_(value)
    slot = _fused_operands(packed, slice(vid, vid + 1))
    for full, s in zip(packed.image.fused, slot):
        full[vid].copy_(s[0])


def program_tensors(packed: PackedProgram) -> list[torch.Tensor]:
    """Every tensor of ``packed``: the source tables, then its exec image."""
    tables = [getattr(packed, f.name) for f in dataclasses.fields(packed)
              if f.name != "image"]
    return tables + ([] if packed.image is None else list(packed.image.fused))


def resident_program(packed: PackedProgram, device=None) -> PackedProgram:
    """A copy of ``packed`` in tensors of its own, with its exec image, on
    ``device`` (``packed``'s own by default): what an executor holds and
    writes in place."""
    if packed.image is None:
        packed = dataclasses.replace(packed, image=build_exec_image(packed))
    device = packed.device if device is None else torch.device(device)

    def own(x):
        return x.to(device, copy=True)
    fields = {f.name: own(getattr(packed, f.name))
              for f in dataclasses.fields(packed) if f.name != "image"}
    image = ExecImage(fused=tiling.ClassifyFusedOperands(
        *(own(x) for x in packed.image.fused)))
    return PackedProgram(**fields, image=image)


def copy_program_(dsts, srcs) -> None:
    """Overwrite each resident program of ``dsts`` with its program of
    ``srcs`` (a swap), tensor by tensor with ``copy_``.  Raises, having
    written nothing, unless every shape and dtype agrees: a graph captured
    over ``dsts`` reads exactly these tensors."""
    pairs = []
    for dst, src in zip(dsts, srcs, strict=True):
        if src.image is None:
            src = dataclasses.replace(src, image=build_exec_image(src))
        pairs += zip(program_tensors(dst), program_tensors(src))
    for d, s in pairs:
        if d.shape != s.shape or d.dtype != s.dtype:
            raise ValueError(
                f"cannot swap in a program of other shapes ({tuple(s.shape)} "
                f"{s.dtype} where {tuple(d.shape)} {d.dtype} is resident): "
                "build a new executor for another profile")
    for d, s in pairs:
        d.copy_(s)


def packed_from_arrays(arrays: dict, profile: PlaneProfile,
                       device=None) -> PackedProgram:
    """A JAX ``PackedProgram``'s source tables, as a dict of numpy arrays
    keyed by field name, -> the port's program with its exec image.  Numpy
    only, so a test can run one installed zoo through both packages."""
    device = torch.device(DEFAULT_DEVICE if device is None else device)
    fields = {}
    for f in dataclasses.fields(PackedProgram):
        if f.name == "image":
            continue
        a = np.asarray(arrays[f.name])
        if f.name in _BOOL_TABLES:
            a = a.astype(bool)
        elif f.name == "vote_weights":
            a = a.astype(np.float32)
        elif f.name not in _U32_TABLES:
            a = a.astype(np.int32)
        fields[f.name] = _tensor(a, device)
    packed = PackedProgram(**fields)
    return dataclasses.replace(packed, image=build_exec_image(packed))


# --------------------------------------------------------------------------
# The classification step
# --------------------------------------------------------------------------
def _classify_impl(packed: PackedProgram, pb: PacketBatch, *, n_classes: int,
                   mode: str | None) -> PacketBatch:
    V = packed.n_versions
    # Classify-boundary VID validation: out-of-range packets are processed
    # against slot 0's tables and their result is forced to -1.
    vid_ok = (pb.vid >= 0) & (pb.vid < V)
    vid = torch.where(vid_ok, pb.vid, 0)
    img = packed.image if packed.image is not None else \
        build_exec_image(packed)
    # Both pipelines in ONE kernel launch (three or L + 2 in the staged
    # modes, every stage bound to the same image); zero bias into the
    # kernels — svm_bias is added below, outside, so partial sums compose.
    codes, tree_label, partial = ops.classify_fused_v(
        pb.codes, pb.features, vid, packed.dt_cv, packed.dt_cm,
        packed.dt_fid, packed.dt_flo, packed.dt_fhi, packed.dt_bit,
        packed.dt_valid, packed.layer_shift, packed.pred_codes,
        packed.pred_labels, packed.pred_valid, packed.vote_weights,
        packed.svm_lut, torch.zeros_like(packed.svm_bias), n_classes,
        mode=mode, prep=img.fused)
    vid_l = vid.to(torch.int64)
    tree_result = torch.where(packed.pred_enable[vid_l], tree_label, -1)

    # ---- svm predict: native adds on the kernel's LUT partials ----
    acc = pb.svm_acc + partial
    sums = acc + packed.svm_bias[vid_l]
    signs = ((sums >= 0) & packed.svm_hvalid[vid_l]).to(torch.int64)
    weights = 1 << torch.arange(signs.shape[1], device=signs.device)
    sign_code = (signs * weights).sum(dim=1)
    svm_label = packed.svm_pred_table[vid_l, sign_code]
    svm_result = torch.where(packed.svm_pred_enable[vid_l], svm_label, -1)

    # ---- result select + forwarding passthrough ----
    # Non-REQUEST packets come out bit-identical: their codes / svm_acc
    # intermediates and rslt are never overwritten (paper §6.1).
    is_req = pb.ptype == PacketType.REQUEST
    codes = torch.where(is_req[:, None], codes, pb.codes)
    acc = torch.where(is_req[:, None], acc, pb.svm_acc)
    result = torch.where(pb.mid == MID_SVM, svm_result, tree_result)
    result = torch.where(vid_ok, result, -1)
    rslt = torch.where(is_req & (result >= 0), result, pb.rslt)
    return dataclasses.replace(pb, codes=codes, svm_acc=acc, rslt=rslt)


class SwitchEngine:
    """One programmable data plane on one device.

    Hosts a model zoo: ``profile.max_versions`` tree programs and as many
    SVMs, resident simultaneously, dispatched per packet by (MID, VID).
    """

    def __init__(self, profile: PlaneProfile, *, mode: str | None = None,
                 device=None) -> None:
        """``device`` defaults to ``cuda``; ``mode`` picks the kernel path
        (``kernels/ops.py``): ``None`` runs the fused CUDA kernel on a CUDA
        device and the twin on the CPU, ``"ref"`` forces the twin, ``"cuda"``
        the kernel wrapper.  ``"unfused[-cuda|-ref]"`` runs the classify as
        three stages (walk, vote, SVM sums: three launches) and
        ``"layerwise[-cuda|-ref]"`` walks layer by layer (L + 2 launches);
        without a suffix their stages follow the device as ``None`` does.
        ``self.mode`` holds the resolved mode."""
        self.profile = profile
        self.device = torch.device(DEFAULT_DEVICE if device is None else device)
        self.mode = ops.resolve_mode(mode, self.device)

    def classify(self, packed: PackedProgram, batch: PacketBatch) -> PacketBatch:
        """Classify ``batch`` (moved to the engine's device once) against
        ``packed``; the result stays on the device."""
        return _classify_impl(packed, batch.to(self.device),
                              n_classes=self.profile.max_classes,
                              mode=self.mode)

    def empty(self) -> PackedProgram:
        return empty_program(self.profile, self.device)

    def install(self, packed: PackedProgram, program: TableProgram,
                stages: set[int] | None = None, *,
                vid: int | None = None) -> PackedProgram:
        return install_program(packed, program, self.profile, stages=stages,
                               vid=vid)

    def evict(self, packed: PackedProgram, *, vid: int,
              kind: str = "all") -> PackedProgram:
        return evict_program(packed, self.profile, vid=vid, kind=kind)
