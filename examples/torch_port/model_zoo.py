"""Scenario: A/B rollout of a new model version with zero recompilation, on
the PyTorch port.

The paper's headline usability claim — "every model (re)deployment only
rewrites match-action entries" (§6) — extended along the Appendix A VID axis:
one plane hosts a *model zoo*, and a rollout is nothing but the request
writer shifting a traffic fraction to a new VID.  The port of
``examples/model_zoo.py``:

  1. train v1, install at vid=0 — 100% of traffic on v1;
  2. train a stronger v2, install at vid=1 *while v1 keeps serving*;
  3. canary: shift 10% → 50% → 100% of requests to v2 by rewriting ``vid``
     in the requests (the plane is untouched);
  4. evict v1 — its slot empties, stragglers get RSLT=-1 (no match), and
     nothing was captured again: install and evict write the resident
     tables in place, and the captured CUDA graph of the batch's admission
     bucket reads them (one graph per bucket, nothing more).

    PYTHONPATH=src python examples/torch_port/model_zoo.py [--device cpu]
"""
import argparse

from repro_torch.core.mlmodels import DecisionTree, Quantizer, accuracy
from repro_torch.core.plane import PlaneProfile
from repro_torch.data import load_dataset
from repro_torch.serving import ZooServer


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--device", default="cuda",
                    help="where the zoo runs (default cuda)")
    args = ap.parse_args(argv)

    Xtr, ytr, Xte, yte = load_dataset("cicids-17", scale=0.04,
                                      max_train=4000)
    q = Quantizer(8).fit(Xtr)
    Xtrq, Xteq = q.transform(Xtr)[:, :36], q.transform(Xte)[:, :36]

    prof = PlaneProfile(max_features=36, max_trees=8, max_layers=12,
                        max_entries_per_layer=256, max_leaves=256,
                        max_classes=8, max_hyperplanes=8, max_versions=4)
    zoo = ZooServer(prof, device=args.device)

    # ---- 1. v1 in production ----
    v1 = DecisionTree(max_depth=5, max_leaf_nodes=24).fit(Xtrq, ytr)
    zoo.install(v1, vid=0, tag="ids-v1")
    r, _ = zoo.classify_split(Xteq, mid=0, split={0: 1.0})
    print(f"v1 serving 100%: acc={accuracy(yte, r):.3f}")

    # ---- 2. v2 trained and installed alongside — v1 keeps serving ----
    v2 = DecisionTree(max_depth=10, max_leaf_nodes=120).fit(Xtrq, ytr)
    zoo.install(v2, vid=1, tag="ids-v2")

    # ---- 3. canary rollout: rewrite vid in requests, nothing else ----
    for frac in (0.1, 0.5, 1.0):
        split = {1: 1.0} if frac == 1.0 else {0: 1.0 - frac, 1: frac}
        r, vids = zoo.classify_split(Xteq, mid=0, split=split)
        cohorts = []
        for v in sorted(split):
            sel = vids == v
            cohorts.append(f"v{v + 1} acc={accuracy(yte[sel], r[sel]):.3f} "
                           f"({int(sel.sum())} pkts)")
        print(f"canary {int(frac * 100):3d}% on v2: " + " | ".join(cohorts))

    # ---- 4. retire v1 ----
    zoo.evict(vid=0, kind="tree")
    straggler = zoo.classify(Xteq, mid=0, vid=0)
    assert (straggler == -1).all(), "evicted slot must answer RSLT=-1"
    final = zoo.classify(Xteq, mid=0, vid=1)
    assert (final == v2.predict(Xteq)).all()
    print(f"v1 evicted (stragglers get RSLT=-1) | v2 acc="
          f"{accuracy(yte, final):.3f}")
    print(f"captured graphs across install/rollout/evict: "
          f"{zoo.cache_size()} (written in place — §6)")
    assert zoo.cache_size() == 1

    # ---- 5. ragged traffic: admission bucketing, O(log B) graphs ----
    # Real request streams don't arrive in one fixed batch size.  The
    # runtime pads each batch into its power-of-two bucket of passthrough
    # packets, so five ragged sizes share a few new buckets here — and
    # replays are free.
    buckets = {zoo.runtime.bucket(Xteq.shape[0])}
    for B in (1, 7, 63, 64, 65):
        r = zoo.classify(Xteq[:B], mid=0, vid=1)
        assert (r == final[:B]).all(), "padding must not change any answer"
        buckets.add(zoo.runtime.bucket(B))
    print(f"ragged batches {{1,7,63,64,65}} + full {Xteq.shape[0]} -> "
          f"{len(buckets)} buckets {sorted(buckets)} = {zoo.cache_size()} "
          "graphs")
    assert zoo.cache_size() == len(buckets)

    # device-out serving: keep results on the device for stacked callers
    dev = zoo.classify(Xteq, mid=0, vid=1, device_out=True)
    assert (dev.rslt.cpu().numpy() == final).all()
    print(f"device_out=True returns the PacketBatch on {dev.device} — no "
          "host round-trip per batch")


if __name__ == "__main__":
    main()
