"""The port's examples (``examples/torch_port/``) run to their end on the
CPU, each the port of the same-named ``examples/*.py`` of the JAX package.

Each runs in this process as ``__main__`` with ``--device cpu`` (the
examples default to the card); an example whose own assert fails raises
here.  Its printed invariants are checked beside: the answers it asserts
equal the trained model, the captured-graph counts, bit-identical async
responses, the lanes' answers, the LM's in-place weight swap, the LM's
loss falling across a checkpoint and restart.
"""
import pathlib
import runpy
import sys

import pytest
from torch_train_lane import one_torch_thread  # noqa: F401 (autouse)

EXAMPLES = pathlib.Path(__file__).resolve().parent.parent / "examples" / \
    "torch_port"
SAYS = {
    "quickstart": ["kappa(in-network, server) = 1.000",
                   "OK: the network computes exactly the trained model."],
    "model_zoo": ["captured graphs across install/rollout/evict: 1",
                  "5 buckets [1, 8, 64, 128, 2048] = 5 graphs",
                  "device_out=True returns the PacketBatch on cpu"],
    "deploy_ids_model": ["captured graphs = 1",
                         "post-failure answers identical"],
    "async_serving": ["every response checked bit-identical to synchronous "
                      "classify"],
    "distributed_inference": ["devices: the CPU",
                              "answers match the forest exactly",
                              "still 1 captured pipeline(s)",
                              "sharded over 4 port lanes (bucket 512) — "
                              "bit-identical answers"],
    "serve_lm": ["decoded 4x32 tokens", "weight swap OK"],
    "train_lm": ["--- simulated preemption at step 20;",
                 "across a restart (OK) on cpu"],
}
# arguments beside --device cpu: train_lm's 300 steps take ~40 s of eight
# CPU cores, its 40 (a preemption at step 20) ~8 s of one
ARGS = {"train_lm": ["--steps", "40"]}


def test_every_example_is_covered():
    assert sorted(p.stem for p in EXAMPLES.glob("*.py")) == sorted(SAYS)


@pytest.mark.parametrize("name", sorted(SAYS))
def test_example_runs_on_the_cpu(name, monkeypatch, capsys):
    path = EXAMPLES / f"{name}.py"
    monkeypatch.setattr(sys, "argv", [str(path), "--device", "cpu",
                                      *ARGS.get(name, [])])
    runpy.run_path(str(path), run_name="__main__")
    out = capsys.readouterr().out
    for line in SAYS[name]:
        assert line in out, f"{name} did not print {line!r}:\n{out}"
