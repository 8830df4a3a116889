"""The CUDA kernel on the card, held to the torch twin.

Every test here needs a CUDA card and skips without one; they import only
``torch``, ``numpy`` and the port, so they run on a machine with no JAX:

    python -m pytest --noconftest -p no:cacheprovider -m gpu tests/test_torch_gpu.py

(``--noconftest``: the shared ``conftest.py`` imports the JAX package.)
Inputs are numpy draws from a seed; every output is an integer and the vote
sums the same f32 weights in the same order, so the tolerance is exact.
"""
import numpy as np
import pytest
import torch

from repro_torch.core import mlmodels as tml
from repro_torch.core.packets import PacketBatch
from repro_torch.core.plane import PlaneProfile, SwitchEngine
from repro_torch.data import load_dataset
from repro_torch.kernels import ref, tiling
from repro_torch.kernels.classify_fused import classify_fused
from repro_torch.serving import ZooServer

pytestmark = pytest.mark.gpu

# (B, T, E, F, V, L, P, C, H, levels, empty zoo slots): the sweep of
# tests/test_fused.py, plus the paper's full profile at a large batch
SWEEP = [
    (7, 1, 3, 4, 1, 1, 4, 2, 1, 16, ()),
    (64, 4, 17, 13, 4, 5, 32, 5, 3, 64, ()),
    (300, 2, 130, 20, 2, 3, 16, 3, 2, 32, ()),
    (257, 3, 33, 21, 8, 8, 64, 6, 4, 64, (1, 5)),
    (33, 5, 64, 40, 1, 32, 128, 8, 8, 128, ()),
    (4097, 8, 128, 60, 4, 32, 256, 32, 12, 256, (3,)),
]


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    return torch.device("cuda")


def random_case(seed, B, T, E, F, V, L, P, C, H, levels, empty, device):
    """The distributions of ``_rand_fused`` in tests/test_fused.py."""
    rng = np.random.default_rng(seed)
    shape = (V, L, T, E)
    flo = rng.integers(0, levels - 1, shape)
    valid = rng.random(shape) < 0.9
    pv = rng.random((V, T, P)) < 0.9
    lut = rng.integers(-60_000, 60_000, (V, H, F, levels))
    for v in empty:
        valid[v], pv[v], lut[v] = False, False, 0
    pc = np.sort(rng.choice(2**16, size=V * T * P, replace=False)
                 .reshape(V, T, P), axis=2)
    arrays = [rng.integers(0, 2**12, (B, T)), rng.integers(0, levels, (B, F)),
              rng.integers(0, V, B), rng.integers(0, 2**6, shape),
              rng.integers(0, 2**6, shape), rng.integers(0, F, shape), flo,
              flo + rng.integers(0, levels // 2, shape),
              rng.integers(0, 2, shape), valid, rng.permutation(L), pc,
              rng.integers(0, C, (V, T, P)), pv,
              rng.random((V, T)).astype(np.float32), lut,
              np.zeros((V, H))]
    return [torch.from_numpy(a if a.dtype in (bool, np.float32)
                             else a.astype(np.int32)).to(device)
            for a in arrays]


@pytest.mark.parametrize("B,T,E,F,V,L,P,C,H,levels,empty", SWEEP)
def test_kernel_matches_twin(cuda, B, T, E, F, V, L, P, C, H, levels, empty):
    args = random_case(B * 31 + V, B, T, E, F, V, L, P, C, H, levels, empty,
                       cuda)
    want = ref.classify_fused_v(*args, C)
    ops_ = tiling.prep_classify_fused(*args[3:10], *args[11:17])
    before = classify_fused.launches
    got = classify_fused(args[0], args[1], args[2], args[10], ops_, C)
    torch.cuda.synchronize()
    assert classify_fused.launches == before + 1
    for g, w in zip(got, want):
        assert torch.equal(g, w)


def test_wrapper_rejects_what_the_kernel_does_not_take(cuda):
    args = random_case(1, 8, 2, 4, 5, 1, 2, 8, 3, 2, 16, (), cuda)
    ops_ = tiling.prep_classify_fused(*args[3:10], *args[11:17])
    with pytest.raises(TypeError):
        classify_fused(args[0].long(), args[1], args[2], args[10], ops_, 3)
    with pytest.raises(ValueError):
        classify_fused(args[0][:, :1], args[1], args[2], args[10], ops_, 3)
    with pytest.raises(ValueError):
        classify_fused(args[0].cpu(), args[1], args[2], args[10], ops_, 3)
    with pytest.raises(ValueError):
        classify_fused(args[0].t().contiguous().t(), args[1], args[2],
                       args[10], ops_, 3)


@pytest.fixture(scope="module")
def satdap_zoo():
    Xtr, ytr, Xte, _ = load_dataset("satdap", scale=0.25)
    q = tml.Quantizer(8).fit(Xtr)
    Xtr, Xte = q.transform(Xtr), q.transform(Xte)
    models = {0: tml.DecisionTree(max_depth=8, max_leaf_nodes=80).fit(Xtr, ytr),
              1: tml.RandomForest(n_estimators=4, max_depth=6,
                                  max_leaf_nodes=40).fit(Xtr, ytr),
              2: tml.LinearSVM(epochs=60).fit(Xtr, ytr)}
    return models, Xte


PROFILE = PlaneProfile(max_features=36, max_trees=5, max_layers=10,
                       max_entries_per_layer=256, max_leaves=256,
                       max_classes=8, max_hyperplanes=8, max_versions=4)


def test_engine_and_server_on_the_card(cuda, satdap_zoo):
    """The zoo on the card: one launch per classify, equal to the twin
    engine on the card and to the server on the CPU."""
    models, X = satdap_zoo
    gzoo, czoo = ZooServer(PROFILE), ZooServer(PROFILE, device="cpu")
    for vid, m in models.items():
        gzoo.install(m, vid=vid)
        czoo.install(m, vid=vid)
    twin = SwitchEngine(PROFILE, mode="ref", device=cuda)
    rng = np.random.default_rng(3)
    for B in (1, 7, 300, X.shape[0]):
        Xb = X[rng.integers(0, X.shape[0], B)]
        vid = rng.integers(0, 4, B).astype(np.int32)
        mid = np.asarray([(0, 1, 2, 0)[v] for v in vid], np.int32)
        before = classify_fused.launches
        got = gzoo.classify(Xb, mid=mid, vid=vid)
        assert classify_fused.launches == before + 1
        np.testing.assert_array_equal(got, czoo.classify(Xb, mid=mid, vid=vid))
        pb = PacketBatch.make_request(
            Xb, mid=mid, vid=vid, max_features=PROFILE.max_features,
            n_trees=PROFILE.max_trees, n_hyperplanes=PROFILE.max_hyperplanes)
        out = gzoo.engine.classify(gzoo.packed, pb)
        want = twin.classify(gzoo.packed, pb)
        for f in ("rslt", "codes", "svm_acc"):
            assert torch.equal(getattr(out, f), getattr(want, f)), f
