"""Serving fronts: the LM prefill / decode steps and ``ZooServer``, the
in-network classifier zoo's front.

Port of ``src/repro/serving/serve.py``: ``make_prefill_step`` (:28),
``make_decode_step`` (:40), ``greedy_decode`` (:178, a Python loop where
JAX has ``lax.scan``) and ``ZooServer`` (:49-175), a ``DataplaneRuntime``
hosting ``profile.max_versions`` resident versions per pipeline, with
install / evict / A-B traffic-split rollout as control-plane operations and
admission bucketing on every classify.  The LM steps serve every family
(``models.transformer``); swapping LM weights is an in-place write into the
same parameter tensors (``LM.init_`` / ``load_``).
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.core.packets import PacketBatch
from repro_torch.core.plane import PackedProgram, PlaneProfile, SwitchEngine
from repro_torch.core.translator import TableProgram, translate
from repro_torch.models.common import ArchConfig
from repro_torch.models.transformer import decode_step, forward
from repro_torch.runtime import DataplaneRuntime, Executor, SingleSwitchExecutor
from repro_torch.runtime import trace

__all__ = ["make_prefill_step", "make_decode_step", "greedy_decode",
           "ZooServer"]


def make_prefill_step(cfg: ArchConfig, *, q_chunk: int = 1024):
    """prefill(params, tokens[, enc_inputs]) -> logits [B, S, V].

    q-chunked attention bounds the logits working set for long prefill."""

    def prefill(params, tokens, enc_inputs=None):
        return forward(params, tokens, cfg, enc_inputs=enc_inputs,
                       q_chunk=q_chunk)

    return prefill


def make_decode_step(cfg: ArchConfig):
    """step(params, state, tokens [B,1], pos) -> (logits [B,1,V], state),
    the caches and recurrent state written in place."""

    def step(params, state, tokens, pos):
        return decode_step(params, state, tokens, pos, cfg)

    return step


def greedy_decode(params, state, first_token: torch.Tensor, pos0: int,
                  cfg: ArchConfig, n_steps: int) -> torch.Tensor:
    """Greedy argmax continuation: feeds ``first_token`` [B, 1] at
    ``pos0`` and each step's argmax after it; returns the ``n_steps``
    tokens produced [B, n_steps]."""
    tok, toks = first_token, []
    for i in range(n_steps):
        logits, state = decode_step(params, state, tok, pos0 + i, cfg)
        tok = torch.argmax(logits[:, -1, :], dim=-1)[:, None].to(tok.dtype)
        toks.append(tok[:, 0])
    return torch.stack(toks, dim=1)


class ZooServer:
    """Stateful serving front over one ``DataplaneRuntime`` model zoo.

    Every ``install`` / ``evict`` / traffic shift is an entry-tensor update
    (the paper's §6 runtime reprogrammability, along the Appendix A VID
    axis); each also re-preps the exec image of *only the written slot*
    (``core/plane.py``).  ``classify_split`` implements A/B rollout: the
    request writer shifts a traffic fraction to a new version by rewriting
    ``vid`` in the requests; the plane is untouched.

    Execution is pluggable: the default is a ``SingleSwitchExecutor`` on
    ``device`` (``cuda`` unless the caller asks for the CPU).
    """

    def __init__(self, profile: PlaneProfile, *, mode: str | None = None,
                 executor: Executor | None = None, device=None) -> None:
        if executor is None:
            executor = SingleSwitchExecutor(profile, mode=mode, device=device)
        self.runtime = DataplaneRuntime(executor)
        self._profile = profile
        self.versions: dict[tuple[str, int], str] = {}  # (pipeline, vid) -> tag

    @property
    def executor(self) -> Executor:
        return self.runtime.executor

    @property
    def engine(self) -> SwitchEngine:
        """The owning plane (single-switch executors only)."""
        return self.executor.engine

    @property
    def packed(self) -> PackedProgram:
        return self.executor.packed

    @property
    def profile(self) -> PlaneProfile:
        return self._profile

    @property
    def row_widths(self) -> tuple[int, int, int]:
        """A request packet's features, tree codes and SVM sums, (F, T, H),
        at this zoo's plane profile."""
        prof = self._profile
        return prof.max_features, prof.max_trees, prof.max_hyperplanes

    def install(self, model_or_program, *, vid: int, tag: str = "") -> int:
        """Install a trained model (or pre-translated program) into slot
        ``vid`` of its pipeline.  Returns the vid for chaining."""
        if isinstance(model_or_program, TableProgram):
            prog = model_or_program
            if prog.vid != vid:
                raise ValueError(
                    f"program targets vid {prog.vid} but install asked for "
                    f"slot {vid} — requests built from the program's metadata "
                    "would dispatch to the wrong slot"
                )
        else:
            prog = translate(model_or_program, vid=vid)
        self.runtime.install(prog, vid=vid)
        pipeline = "svm" if prog.kind == "svm" else "tree"
        self.versions[(pipeline, vid)] = tag or f"{prog.kind}-v{vid}"
        return vid

    def evict(self, *, vid: int, kind: str = "all") -> None:
        self.runtime.evict(vid=vid, kind=kind)
        for pipeline in ("tree", "svm"):
            if kind in (pipeline, "all"):
                self.versions.pop((pipeline, vid), None)

    def make_request(self, features, *, mid: int = 0, vid=0) -> PacketBatch:
        """Build a REQUEST batch (host tensors) sized to this zoo's plane
        profile: the request of ``submit``, the coalesced and the open-loop
        paths (``classify`` writes the same batch in place)."""
        F, T, H = self.row_widths
        with trace.span("request"):
            return PacketBatch.make_request(
                features, mid=mid, vid=vid, max_features=F, n_trees=T,
                n_hyperplanes=H, max_versions=self.profile.max_versions)

    def classify(self, features, *, mid: int, vid: int | np.ndarray,
                 device_out: bool = False) -> np.ndarray | PacketBatch:
        """Classify one request batch (admission-bucketed, any size).

        ``device_out=True`` returns the classified ``PacketBatch`` on the
        device instead of the host ``rslt`` array."""
        with trace.span("classify"):
            # the request is written once, straight into a staging buffer
            # at its bucket (same batch and checks as make_request)
            out = self.runtime.run_request(
                features, mid=mid, vid=vid, row_widths=self.row_widths,
                max_versions=self.profile.max_versions)
            if device_out:
                return out
            with trace.span("copy_out"):
                return out.rslt.cpu().numpy()

    def classify_coalesced(self, requests) -> list[np.ndarray]:
        """Classify several per-client request batches as ONE dispatch.

        ``requests`` is a sequence of ``(features, mid, vid)`` triples; the
        per-client results equal calling ``classify`` once per triple."""
        pbs = [self.make_request(f, mid=m, vid=v) for f, m, v in requests]
        return [out.rslt.cpu().numpy()
                for out in self.runtime.run_coalesced(pbs)]

    def classify_split(self, features, *, mid: int,
                       split: dict[int, float]) -> tuple[np.ndarray, np.ndarray]:
        """A/B rollout step: route a deterministic fraction of requests to
        each version in ``split`` (vid -> fraction, summing to ~1).  Returns
        (results, per-packet vid) so callers can track cohort metrics."""
        if not split:
            raise ValueError("split needs at least one vid -> fraction entry")
        B = np.asarray(features).shape[0]
        vids_sorted = sorted(split)
        bounds = np.cumsum([split[v] for v in vids_sorted])
        if not np.isclose(bounds[-1], 1.0, atol=1e-6):
            raise ValueError(f"traffic fractions sum to {bounds[-1]}, not 1")
        # deterministic low-discrepancy assignment by packet index; clip so
        # a fraction sum of 1-eps cannot index past the last version
        u = (np.arange(B) + 0.5) / B
        idx = np.minimum(np.searchsorted(bounds, u), len(vids_sorted) - 1)
        vids = np.asarray(vids_sorted, np.int32)[idx]
        return self.classify(features, mid=mid, vid=vids), vids

    def cache_size(self) -> int:
        """Captured classifies of the executor (one per admission bucket)."""
        return self.runtime.cache_size()
