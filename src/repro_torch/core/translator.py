"""ACORN's code translator (paper §3.2, §4): trained model → TableProgram.

A ``TableProgram`` is the network-level object: the ordered stages of
match-action tables the deployment planner places onto devices, plus the
table structs the plane engine packs into runtime-swappable entry arrays.

Stage layout follows the paper's data plane design (Fig. 5):

* decision tree  — one ``dt_layer`` table per layer (stage), then a
  ``dt_predict`` stage;
* random forest  — trees are processed **two per block** ("at each stage, two
  DT_layer tables are grouped into a block"): trees (0,1) occupy stages
  0..D-1, trees (2,3) stages D..2D-1, ...; then one stage holding all
  ``dt_predict`` tables and one ``multitree_voting`` stage;
* SVM            — ``svm_mul`` tables grouped ``muls_per_stage`` per stage
  ("multiple multiplication tables can be placed in the same pipeline
  stage"), then the ``svm_predict`` stage; the native-adder hyperplane sums
  cost ALU, not entries.

Copied from ``src/repro/core/translator.py`` of the JAX package; only the import
paths differ (the port imports nothing from ``repro``).
"""
from __future__ import annotations

import dataclasses

import numpy as np

from repro_torch.core.mlmodels.cart import DecisionTree
from repro_torch.core.mlmodels.forest import RandomForest
from repro_torch.core.mlmodels.linsvm import LinearSVM
from repro_torch.core.tables import (
    DtLayerTable,
    DtPredictTable,
    SvmMulTable,
    SvmPredictTable,
    VotingTable,
)

__all__ = [
    "TableSpec",
    "StageSpec",
    "TableProgram",
    "translate",
    "translate_decision_tree",
    "translate_random_forest",
    "translate_svm",
]

MID_DT, MID_RF, MID_SVM = 0, 1, 2


@dataclasses.dataclass(frozen=True)
class TableSpec:
    """Resource footprint of one table — the planner's t_{i,j}."""

    kind: str            # dt_layer | dt_predict | multitree_voting | svm_mul | svm_predict
    logical_entries: int
    tcam_entries: int    # physical TCAM after range->prefix expansion
    sram_entries: int
    tree: int = -1       # owning tree (dt) — for reporting
    layer: int = -1
    hyperplane: int = -1  # owning hyperplane (svm) — colocation constraint


@dataclasses.dataclass(frozen=True)
class StageSpec:
    index: int
    tables: tuple[TableSpec, ...]

    @property
    def tcam_entries(self) -> int:
        return sum(t.tcam_entries for t in self.tables)

    @property
    def sram_entries(self) -> int:
        return sum(t.sram_entries for t in self.tables)

    @property
    def hyperplanes(self) -> tuple[int, ...]:
        return tuple(sorted({t.hyperplane for t in self.tables if t.hyperplane >= 0}))


@dataclasses.dataclass
class TableProgram:
    kind: str  # "dt" | "rf" | "svm"
    mid: int
    vid: int   # model-zoo version slot this program targets (Appendix A VID)
    n_features: int
    n_classes: int
    feature_width: int
    levels: int
    # tree-family payload
    dt_layers: list[list[DtLayerTable]] = dataclasses.field(default_factory=list)  # [tree][layer]
    dt_predicts: list[DtPredictTable] = dataclasses.field(default_factory=list)
    voting: VotingTable | None = None
    # svm payload
    svm_muls: list[SvmMulTable] = dataclasses.field(default_factory=list)
    svm_predict: SvmPredictTable | None = None
    svm_bias: np.ndarray | None = None  # int32 [H] fixed-point
    frac_bits: int = 12
    muls_per_stage: int = 8
    trees_per_block: int = 2

    def __post_init__(self):
        if self.vid < 0:
            raise ValueError(
                f"vid {self.vid} invalid: the ACORN VID header field is "
                "unsigned (version slots are 0-indexed)"
            )

    # ------------------------------------------------------------ structure
    @property
    def n_trees(self) -> int:
        return len(self.dt_layers)

    @property
    def n_hyperplanes(self) -> int:
        return 0 if self.svm_predict is None else self.svm_predict.n_hyperplanes

    @property
    def tree_depths(self) -> list[int]:
        return [len(layers) for layers in self.dt_layers]

    def stages(self) -> list[StageSpec]:
        """Planner input: ordered program stages with per-table footprints."""
        out: list[StageSpec] = []
        if self.kind in ("dt", "rf"):
            tpb = self.trees_per_block
            for blk_start in range(0, self.n_trees, tpb):
                block = list(range(blk_start, min(blk_start + tpb, self.n_trees)))
                depth = max(len(self.dt_layers[t]) for t in block)
                for layer in range(depth):
                    tabs = []
                    for t in block:
                        if layer < len(self.dt_layers[t]):
                            lt = self.dt_layers[t][layer]
                            tabs.append(
                                TableSpec(
                                    "dt_layer",
                                    lt.n_entries,
                                    lt.n_tcam_entries,
                                    0,
                                    tree=t,
                                    layer=layer,
                                )
                            )
                    out.append(StageSpec(len(out), tuple(tabs)))
            pred_tabs = tuple(
                TableSpec("dt_predict", p.n_entries, 0, p.n_entries, tree=p.tree)
                for p in self.dt_predicts
            )
            out.append(StageSpec(len(out), pred_tabs))
            if self.voting is not None and self.n_trees > 1:
                out.append(
                    StageSpec(
                        len(out),
                        (
                            TableSpec(
                                "multitree_voting",
                                self.voting.n_entries,
                                0,
                                self.voting.n_entries,
                            ),
                        ),
                    )
                )
        elif self.kind == "svm":
            for muls in self.svm_stage_muls():
                tabs = tuple(
                    TableSpec(
                        "svm_mul",
                        self.svm_muls[k].n_entries,
                        0,
                        self.svm_muls[k].n_entries,
                        hyperplane=self.svm_muls[k].hyperplane,
                    )
                    for k in muls
                )
                out.append(StageSpec(len(out), tabs))
            sp = self.svm_predict
            out.append(
                StageSpec(
                    len(out),
                    (TableSpec("svm_predict", sp.n_entries, 0, sp.n_entries),),
                )
            )
        return out

    def svm_stage_muls(self) -> list[list[int]]:
        """Mul-table indices per stage. Stages never straddle hyperplanes, so
        the colocation integrity constraint (paper §5.3) maps to whole stages."""
        by_h: dict[int, list[int]] = {}
        for k, m in enumerate(self.svm_muls):
            by_h.setdefault(m.hyperplane, []).append(k)
        stages: list[list[int]] = []
        mps = self.muls_per_stage
        for h in sorted(by_h):
            ms = by_h[h]
            for i in range(0, len(ms), mps):
                stages.append(ms[i : i + mps])
        return stages

    @property
    def n_stages(self) -> int:
        return len(self.stages())

    def total_tcam_entries(self) -> int:
        return sum(s.tcam_entries for s in self.stages())

    def total_sram_entries(self) -> int:
        return sum(s.sram_entries for s in self.stages())


# --------------------------------------------------------------------------
# Translators
# --------------------------------------------------------------------------
def _tree_layer_tables(dt: DecisionTree, tree_idx: int, feature_width: int) -> list[DtLayerTable]:
    t = dt.tree_
    layers: list[DtLayerTable] = []
    full = (1 << feature_width) - 1
    for depth, nodes in t.internal_by_depth():
        cv, cm, fid, flo, fhi, prio, bit = [], [], [], [], [], [], []
        mask = np.uint32((1 << depth) - 1)
        for n in nodes:
            p = np.uint32(int(t.path[n]) & int(mask))
            f, thr = int(t.feature[n]), int(t.threshold[n])
            # high-priority `x[f] <= thr` -> branch 0 (left)
            cv.append(p); cm.append(mask); fid.append(f)
            flo.append(0); fhi.append(thr); prio.append(1); bit.append(0)
            # low-priority catch-all -> branch 1 (right); priority trick, Fig. 3
            cv.append(p); cm.append(mask); fid.append(f)
            flo.append(0); fhi.append(full); prio.append(0); bit.append(1)
        layers.append(
            DtLayerTable(
                layer=depth,
                tree=tree_idx,
                code_value=np.asarray(cv, np.uint32),
                code_mask=np.asarray(cm, np.uint32),
                fid=np.asarray(fid, np.int32),
                f_lo=np.asarray(flo, np.int32),
                f_hi=np.asarray(fhi, np.int32),
                priority=np.asarray(prio, np.int32),
                set_bit=np.asarray(bit, np.uint8),
                feature_width=feature_width,
            )
        )
    # Contiguous layers 0..D-1 (internal_by_depth only yields non-empty ones,
    # which for a tree are exactly 0..max_internal_depth).
    return layers


def _tree_predict_table(dt: DecisionTree, tree_idx: int) -> DtPredictTable:
    t = dt.tree_
    leaves = t.leaves()
    return DtPredictTable(
        tree=tree_idx,
        codes=t.path[leaves].astype(np.uint32),
        labels=t.label[leaves].astype(np.int32),
    )


def translate_decision_tree(
    dt: DecisionTree, *, vid: int = 0, feature_width: int = 8
) -> TableProgram:
    if dt.tree_ is None:
        raise ValueError("fit the tree first")
    if dt.tree_.max_depth > 32:
        raise ValueError("status code is 32-bit: depth must be <= 32 (paper limit)")
    return TableProgram(
        kind="dt",
        mid=MID_DT,
        vid=vid,
        n_features=dt.n_features_,
        n_classes=dt.n_classes_,
        feature_width=feature_width,
        levels=dt.levels,
        dt_layers=[_tree_layer_tables(dt, 0, feature_width)],
        dt_predicts=[_tree_predict_table(dt, 0)],
        voting=None,
    )


def translate_random_forest(
    rf: RandomForest, *, vid: int = 0, feature_width: int = 8, trees_per_block: int = 2
) -> TableProgram:
    if not rf.trees_:
        raise ValueError("fit the forest first")
    return TableProgram(
        kind="rf",
        mid=MID_RF,
        vid=vid,
        n_features=rf.n_features_,
        n_classes=rf.n_classes_,
        feature_width=feature_width,
        levels=rf.levels,
        dt_layers=[_tree_layer_tables(t, i, feature_width) for i, t in enumerate(rf.trees_)],
        dt_predicts=[_tree_predict_table(t, i) for i, t in enumerate(rf.trees_)],
        voting=VotingTable.build(
            len(rf.trees_),
            rf.n_classes_,
            None if rf.tree_weights is None else np.asarray(rf.tree_weights),
        ),
        trees_per_block=trees_per_block,
    )


def translate_svm(
    svm: LinearSVM, *, vid: int = 0, feature_width: int = 8, frac_bits: int = 12,
    muls_per_stage: int = 8,
) -> TableProgram:
    if svm.W_ is None:
        raise ValueError("fit the SVM first")
    H, F = svm.W_.shape
    levels = svm.levels
    S = float(1 << frac_bits)
    centers = (np.arange(levels) + 0.5) / levels
    muls = []
    for h in range(H):
        for f in range(F):
            lut = np.round(svm.W_[h, f] * centers * S).astype(np.int32)
            muls.append(SvmMulTable(hyperplane=h, feature=f, lut=lut))
    bias = np.round(svm.b_ * S).astype(np.int32)
    pairs = np.asarray(svm.pairs_, dtype=np.int32)
    pred = SvmPredictTable.build(pairs, svm.n_classes_, svm.votes_from_signs)
    return TableProgram(
        kind="svm",
        mid=MID_SVM,
        vid=vid,
        n_features=F,
        n_classes=svm.n_classes_,
        feature_width=feature_width,
        levels=levels,
        svm_muls=muls,
        svm_predict=pred,
        svm_bias=bias,
        frac_bits=frac_bits,
        muls_per_stage=muls_per_stage,
    )


def translate(model, **kw) -> TableProgram:
    """Single entry point (the paper's API: submit a trained Python model)."""
    if isinstance(model, DecisionTree):
        return translate_decision_tree(model, **kw)
    if isinstance(model, RandomForest):
        return translate_random_forest(model, **kw)
    if isinstance(model, LinearSVM):
        return translate_svm(model, **kw)
    raise TypeError(f"unsupported model type {type(model).__name__} (paper supports DT/RF/SVM)")
